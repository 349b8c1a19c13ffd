"""Out-of-core streaming execution of lazy query plans (paper §VI scaled).

Mirrors the serial route of :mod:`repro.core.streaming`.  A trace opened
with ``Trace.open(paths, streaming=True)`` is a :class:`StreamingTrace`:
a handle over its files that is never materialized.  A terminal op on it
(or on a plan over it) runs chunk by chunk:

* readers yield bounded EventFrames (``iter_chunks`` in the reader
  registry, or a whole-file read sliced into chunks);
* the plan's **fused mask** is applied to each chunk (one boolean AND per
  chunk, as the in-memory fusion path does);
* structure-dependent ops get **completed-call records** stitched across
  chunk boundaries by :class:`CallStitcher`: within-chunk pairs are matched
  by the same vectorized code the in-memory path uses, and calls split
  across a boundary (an open ``main()`` spans every boundary) are carried
  on per-(process, thread) stacks until their leave arrives;
* each op's **streaming aggregator** buffers the records its kernel
  reduces and, in ``result()``, sorts them into the canonical order and
  makes one kernel call on the handle's ``device`` — the same record
  multiset in the same order as the in-memory op, so the card gives the
  same bits on both routes.

A handle carries a ``device`` (``"cuda"`` unless the caller asks for the
CPU) and hands it to its ops' kernel calls.  Ops with no streaming form
raise :class:`StreamingUnsupported` naming the escape hatches.  Not yet
ported: the parallel executor (``processes=``, ``executor="parallel"``)
and live handles (ROADMAP §A.3).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, \
    Tuple

import numpy as np

from . import registry, structure
from .accel import resolve_device
from .constants import ENTER, ET, EXC, INC, LEAVE, NAME, PROC, THREAD, TS
from .errors import IngestReport
from .frame import Categorical, EventFrame, concat

__all__ = ["StreamingTrace", "StreamingUnsupported", "StreamAgg",
           "GlobalNames", "CallBlock", "Chunk", "StreamStats",
           "StreamContext", "CallStitcher", "execute_streaming",
           "iter_chunks_fallback", "grow_to", "fold_frames", "mask_frames",
           "stats_from_frames"]

DEFAULT_CHUNK_ROWS = 1_000_000


class StreamingUnsupported(RuntimeError):
    """A plan or op has no out-of-core form.  The message always names the
    escape hatches: ``.collect()`` (materialize, then run eagerly) or
    ``Trace.open(..., streaming=False)``."""


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not yet ported (ROADMAP §A.3); the port streams "
        f"serially")


# ---------------------------------------------------------------------------
# shared name space across chunks
# ---------------------------------------------------------------------------

class GlobalNames:
    """Interner mapping every chunk's local Categorical onto one stable
    global code space (codes are assigned in first-seen order; results that
    need the in-memory alphabetical order sort at finalize time)."""

    def __init__(self):
        self._code: Dict[str, int] = {}
        self.names: List[str] = []

    def encode(self, cat: Categorical) -> np.ndarray:
        """Global int64 code per row of ``cat``."""
        local = np.empty(len(cat.categories), np.int64)
        for i, c in enumerate(cat.categories):
            local[i] = self.intern(str(c))
        return local[cat.codes]

    def intern(self, name: str) -> int:
        """Code of ``name``, assigning the next one on first sight."""
        g = self._code.get(name)
        if g is None:
            g = len(self.names)
            self._code[name] = g
            self.names.append(name)
        return g

    def __len__(self) -> int:
        return len(self.names)


def grow_to(arr: np.ndarray, shape: Tuple[int, ...], fill=0) -> np.ndarray:
    """Return ``arr`` grown (power-of-two per axis) to hold ``shape`` —
    the accumulator pattern streaming aggregators use while the name/process
    universe is still being discovered."""
    target = []
    need = False
    for have, want in zip(arr.shape, shape):
        if want > have:
            cap = max(have, 1)
            while cap < want:
                cap *= 2
            target.append(cap)
            need = True
        else:
            target.append(have)
    if not need:
        return arr
    out = np.full(tuple(target), fill, dtype=arr.dtype)
    out[tuple(slice(0, n) for n in arr.shape)] = arr
    return out


# ---------------------------------------------------------------------------
# chunk payloads
# ---------------------------------------------------------------------------

class CallBlock:
    """Completed calls discovered in one chunk: one entry per call whose
    Leave arrived (whether its Enter was in this chunk or carried over)."""

    __slots__ = ("name", "proc", "start", "end", "inc", "exc")

    def __init__(self, name, proc, start, end, inc, exc):
        self.name = name      # global name codes (int64)
        self.proc = proc      # int64
        self.start = start    # float64 enter timestamps
        self.end = end        # float64 leave timestamps
        self.inc = inc        # float64 inclusive ns
        self.exc = exc        # float64 exclusive ns


class Chunk:
    """What an aggregator sees per chunk: the masked frame, its rows' global
    name codes, and (when requested) the completed-call block."""

    __slots__ = ("events", "gcodes", "calls", "names")

    def __init__(self, events: EventFrame, gcodes: np.ndarray,
                 calls: Optional[CallBlock], names: GlobalNames):
        self.events = events
        self.gcodes = gcodes
        self.calls = calls
        self.names = names


class StreamStats:
    """Whole-stream facts from one pass (:meth:`StreamingTrace.stats`)."""

    __slots__ = ("n_events", "ts_min", "ts_max", "proc_max")

    def __init__(self):
        self.n_events = 0
        self.ts_min = np.inf
        self.ts_max = -np.inf
        self.proc_max = -1

    @property
    def num_processes(self) -> int:
        return self.proc_max + 1


class StreamAgg:
    """Base class for streaming aggregators: the executor calls ``update``
    once per masked chunk, then ``result`` once.

    The reference's aggregators can also take a statistics pre-pass
    (``needs_stats``: a second read of the stream for global bin edges),
    which its per-chunk histograms need.  The port's aggregators buffer the
    records their kernel reduces and fix bin edges in ``result``, from
    the same values the in-memory op uses, so none needs one.
    """

    needs_calls = False   # completed-call records (structure across chunks)

    def update(self, chunk: Chunk) -> None:
        raise NotImplementedError

    def result(self, ctx: "StreamContext") -> Any:
        raise NotImplementedError


class StreamContext:
    """Finalization context: the global name table and the (name code,
    process) pairs of calls left open at end of stream (their Leave never
    arrived — the in-memory path's unmatched enters)."""

    __slots__ = ("names", "open_calls", "proc_max")

    def __init__(self, names: GlobalNames,
                 open_calls: Tuple[np.ndarray, np.ndarray], proc_max: int):
        self.names = names
        self.open_calls = open_calls
        self.proc_max = proc_max

    @property
    def num_processes(self) -> int:
        return self.proc_max + 1


# ---------------------------------------------------------------------------
# cross-chunk call stitching
# ---------------------------------------------------------------------------

class _Frame:
    """One open call carried across chunk boundaries."""

    __slots__ = ("name", "proc", "start", "child_inc")

    def __init__(self, name: int, proc: int, start: float):
        self.name = name
        self.proc = proc
        self.start = start
        self.child_inc = 0.0


class CallStitcher:
    """Turns a sorted chunk stream into completed-call records, stitching
    enter/leave pairs split across chunk boundaries.

    Within a chunk, pairs are matched with the same vectorized code the
    in-memory path uses (:func:`repro_torch.core.structure.derive_structure`)
    and their inclusive/exclusive times come from the same
    ``compute_inc_exc`` — all direct children of a within-chunk call are
    inside the chunk, so those values are exact.  Events the chunk cannot
    resolve are exactly the boundary ones: an Enter whose Leave is in a
    later chunk is pushed on a per-(process, thread) carry stack; an
    unmatched Leave pops the innermost open carried call and completes it.
    Exclusive time of a carried call is its inclusive time minus the child
    time accumulated on its stack frame — chunk-level top calls are
    bucket-summed onto the innermost open frame between boundary events, so
    no per-event Python loop ever runs.

    Requires each (process, thread) sub-stream to arrive in non-decreasing
    time order (files written per rank or in (process, time) order satisfy
    this); violations raise StreamingUnsupported.
    """

    def __init__(self):
        self._stacks: Dict[int, List[_Frame]] = {}
        self._last_ts: Dict[int, float] = {}

    # -- public ------------------------------------------------------------
    def push_chunk(self, ev: EventFrame, gcodes: np.ndarray) -> CallBlock:
        n = len(ev)
        if n == 0:
            return CallBlock(*[np.empty(0, np.int64)] * 2,
                             *[np.empty(0, np.float64)] * 4)
        gkey = self._group_key_rows(ev)
        ts = np.asarray(ev[TS], np.float64)
        self._check_sorted(gkey, ts)

        matching, _depth, parent, inc, exc = structure.derive_structure(ev)

        et = ev.cat(ET)
        is_enter = et.mask_eq(ENTER)
        is_leave = et.mask_eq(LEAVE)
        procs = np.asarray(ev[PROC], np.int64)

        matched_ent = np.nonzero(is_enter & (matching >= 0))[0]
        # chunk-level top calls: matched calls whose parent the chunk cannot
        # see — their inclusive time belongs to the innermost open carried
        # call at their position
        top_ent = matched_ent[parent[matched_ent] < 0]

        boundary = np.nonzero((is_enter | is_leave) & (matching < 0))[0]
        # matched calls whose parent is a *boundary enter of this chunk*
        # (the parent's own exc is NaN here — its frame is pushed below):
        # credit their inclusive time straight onto that frame
        par = parent[matched_ent]
        bp = matched_ent[par >= 0]
        bp = bp[(matching[parent[bp]] < 0) & is_enter[parent[bp]]]
        pending_child = {}
        if len(bp):
            add = np.zeros(n)
            np.add.at(add, parent[bp], inc[bp])
            pending_child = {int(r): float(add[r])
                             for r in np.unique(parent[bp])}
        carried = self._stitch(gkey, gcodes, ts, procs, is_enter,
                               boundary, top_ent, inc, pending_child)

        name = gcodes[matched_ent]
        proc = procs[matched_ent]
        start = ts[matched_ent]
        end = ts[matching[matched_ent]]
        binc = inc[matched_ent]
        bexc = exc[matched_ent]
        if carried:
            cn, cp, cs, ce, ci, cx = (np.asarray(c) for c in zip(*carried))
            name = np.concatenate([name, cn.astype(np.int64)])
            proc = np.concatenate([proc, cp.astype(np.int64)])
            start = np.concatenate([start, cs])
            end = np.concatenate([end, ce])
            binc = np.concatenate([binc, ci])
            bexc = np.concatenate([bexc, cx])
        return CallBlock(name, proc, start, end, binc, bexc)

    def open_calls(self) -> Tuple[np.ndarray, np.ndarray]:
        """(global name codes, process ids) of calls still open at end of
        stream — their Leave never arrived, i.e. the in-memory matcher's
        unmatched enters."""
        frames = [f for st in self._stacks.values() for f in st]
        return (np.asarray([f.name for f in frames], np.int64),
                np.asarray([f.proc for f in frames], np.int64))

    # -- internals -----------------------------------------------------------
    def _check_sorted(self, gkey: np.ndarray, ts: np.ndarray) -> None:
        order = np.lexsort((np.arange(len(gkey)), gkey))
        g_s, t_s = gkey[order], ts[order]
        same = g_s[1:] == g_s[:-1]
        if np.any(same & (np.diff(t_s) < 0)):
            raise StreamingUnsupported(
                "streaming execution needs each (process, thread) event "
                "stream in non-decreasing time order within a chunk; this "
                "trace is not sorted.  Re-shard it per rank or open with "
                "streaming=False.")
        firsts = np.nonzero(np.concatenate([[True], ~same]))[0]
        for i in firsts:
            last = self._last_ts.get(int(g_s[i]))
            if last is not None and t_s[i] < last:
                raise StreamingUnsupported(
                    "streaming execution needs each (process, thread) event "
                    "stream in non-decreasing time order across chunks; "
                    "this trace interleaves out of order.  Re-shard it or "
                    "open with streaming=False.")
        # record per-group max ts of this chunk
        lasts = np.nonzero(np.concatenate([~same, [True]]))[0]
        for i in lasts:
            self._last_ts[int(g_s[i])] = float(t_s[i])

    def _stitch(self, gkey, gcodes, ts, procs, is_enter, boundary,
                top_ent, inc, pending_child) -> List[tuple]:
        """Walk boundary events per group in row order, bucket-attributing
        chunk-top call time to the innermost open carried frame."""
        completed: List[tuple] = []
        if len(boundary) == 0 and not self._stacks:
            return completed
        # bucket chunk-top calls between boundary events, per group
        by_group_b: Dict[int, np.ndarray] = {}
        for g in np.unique(gkey[boundary]) if len(boundary) else []:
            by_group_b[int(g)] = boundary[gkey[boundary] == g]
        by_group_t: Dict[int, np.ndarray] = {}
        if len(top_ent):
            for g in np.unique(gkey[top_ent]):
                by_group_t[int(g)] = top_ent[gkey[top_ent] == g]

        for g in set(by_group_b) | set(by_group_t):
            stack = self._stacks.setdefault(g, [])
            b_rows = by_group_b.get(g, np.empty(0, np.int64))
            t_rows = by_group_t.get(g, np.empty(0, np.int64))
            # which boundary interval each top call falls into: index of the
            # first boundary row after it
            bucket = np.searchsorted(b_rows, t_rows)
            # per-bucket inclusive-time sums (tops between boundary events)
            sums = np.zeros(len(b_rows) + 1)
            counts = np.zeros(len(b_rows) + 1, np.int64)
            if len(t_rows):
                np.add.at(sums, bucket, inc[t_rows])
                np.add.at(counts, bucket, 1)

            def attribute(k):
                if counts[k] and stack:
                    stack[-1].child_inc += float(sums[k])

            attribute(0)
            for k, r in enumerate(b_rows):
                if is_enter[r]:
                    fr = _Frame(int(gcodes[r]), int(procs[r]), float(ts[r]))
                    fr.child_inc += pending_child.get(int(r), 0.0)
                    stack.append(fr)
                elif stack:
                    fr = stack.pop()
                    c_inc = float(ts[r]) - fr.start
                    c_exc = c_inc - fr.child_inc
                    completed.append((fr.name, fr.proc, fr.start,
                                      float(ts[r]), c_inc, c_exc))
                    if stack:
                        stack[-1].child_inc += c_inc
                # else: a leave with no open call anywhere upstream — the
                # in-memory matcher leaves it unmatched too; ignore
                attribute(k + 1)
            if not stack:
                self._stacks.pop(g, None)
        return completed

    @staticmethod
    def _group_key_rows(ev: EventFrame) -> np.ndarray:
        """One stable (process, thread) integer key per row — identical
        across every chunk of a stream, since it indexes the carry stacks.
        2³² headroom for the thread id: traces that keep raw OS tids must
        not collide across processes."""
        proc = np.asarray(ev[PROC], np.int64)
        if THREAD in ev:
            thread = np.asarray(ev[THREAD], np.int64)
        else:
            thread = np.zeros_like(proc)
        return proc * (1 << 32) + thread


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------

def _validate_steps(steps: Sequence) -> None:
    from .query import SliceTimeStep
    for step in steps:
        if step.reads_derived():
            raise StreamingUnsupported(
                f"streaming plans cannot filter on derived columns "
                f"({step.describe()}): those values depend on the selected "
                f"frame.  Materialize first with .collect() or open with "
                f"streaming=False.")
        if isinstance(step, SliceTimeStep) and step.trim == "overlap":
            raise StreamingUnsupported(
                "slice_time(trim='overlap') extends the window through "
                "enter/leave matching, which streaming chunks cannot see "
                "ahead of time.  Use trim='within', or materialize with "
                ".collect() / streaming=False.")


def mask_frames(frames: Iterator[EventFrame], steps: Sequence,
                device="cuda") -> Iterator[EventFrame]:
    """The fused-mask-per-chunk pipeline: every frame the source yields is
    masked once with the AND of all step masks (mask fusion, per chunk).
    ``device`` is the handle's: the masks run on the host either way."""
    from .trace import Trace
    for frame in frames:
        if not steps:
            yield frame
            continue
        t = Trace(frame, device=device)
        mask = None
        for step in steps:
            m = step.mask(t)
            mask = m if mask is None else (mask & m)
        yield frame if mask.all() else frame.mask(mask)


def stats_from_frames(frames: Iterator[EventFrame]) -> StreamStats:
    """One StreamStats pass over ``frames``."""
    st = StreamStats()
    for frame in frames:
        n = len(frame)
        if n == 0:
            continue
        st.n_events += n
        ts = np.asarray(frame[TS], np.float64)
        st.ts_min = min(st.ts_min, float(ts.min()))
        st.ts_max = max(st.ts_max, float(ts.max()))
        st.proc_max = max(st.proc_max,
                          int(np.asarray(frame[PROC], np.int64).max()))
    return st


def fold_frames(frames: Iterator[EventFrame], agg: StreamAgg,
                names: GlobalNames,
                stitcher: Optional[CallStitcher]) -> int:
    """Feed masked frames through the name interner / call stitcher into
    ``agg``.  Returns the max process id seen (or -1)."""
    proc_max = -1
    for frame in frames:
        if len(frame) == 0:
            continue
        gcodes = names.encode(frame.cat(NAME))
        calls = stitcher.push_chunk(frame, gcodes) if stitcher else None
        proc_max = max(proc_max, int(np.asarray(frame[PROC], np.int64).max()))
        agg.update(Chunk(frame, gcodes, calls, names))
    return proc_max


def execute_streaming(handle: "StreamingTrace", steps: Sequence,
                      spec: registry.OpSpec, args: tuple,
                      kwargs: dict) -> Any:
    """Run one registered op out of core over ``handle`` under ``steps``:
    one pass that folds every masked chunk into the op's aggregator, then
    its ``result()``."""
    if spec.streaming is None:
        raise StreamingUnsupported(
            f"op {spec.name!r} has no combinable streaming form (it needs "
            f"the whole trace structure at once).  Materialize with "
            f".collect().{spec.name}(...) on the collected trace, or open "
            f"with streaming=False.")
    _validate_steps(steps)
    agg: StreamAgg = spec.streaming(*args, **kwargs)
    names = GlobalNames()
    stitcher = CallStitcher() if agg.needs_calls else None
    proc_max = fold_frames(mask_frames(handle._iter_frames(), steps,
                                       handle.device), agg, names, stitcher)
    open_calls = (stitcher.open_calls() if stitcher
                  else (np.empty(0, np.int64), np.empty(0, np.int64)))
    return agg.result(StreamContext(names, open_calls, proc_max))


# ---------------------------------------------------------------------------
# what the streaming aggregators share
# ---------------------------------------------------------------------------

_CALL_METRICS = (INC, EXC)


def check_metric(metric: str, op: str) -> None:
    """Streaming ops reduce completed-call records, which carry ``time.inc``
    and ``time.exc`` only."""
    if metric not in _CALL_METRICS:
        raise StreamingUnsupported(
            f"streaming {op} supports metrics {_CALL_METRICS}, got "
            f"{metric!r}; materialize with .collect() for custom metrics")


class RecordBuffer:
    """Completed-call records buffered across chunks for one kernel call at
    the end: ``add`` keeps (name code, process, start, end, value columns)
    of a chunk's calls (those ``keep`` selects), ``gather`` concatenates
    them with each name's alphabetical position in place of its global
    code."""

    def __init__(self, width: int = 1):
        self.width = width
        self._parts: List[tuple] = []

    def add(self, calls: CallBlock, values: np.ndarray,
            keep=slice(None)) -> None:
        self._parts.append((calls.name[keep], calls.proc[keep],
                            calls.start[keep], calls.end[keep],
                            np.asarray(values, np.float64)[keep]))

    def gather(self, inv: np.ndarray):
        """(alphabetical positions, procs, starts, ends, values)."""
        if not self._parts:
            z = np.zeros(0)
            return (np.zeros(0, np.int64), np.zeros(0, np.int64), z, z,
                    np.zeros((0, self.width)))
        name, proc, start, end, vals = (np.concatenate(c) for c in
                                        zip(*self._parts))
        return inv[name], proc, start, end, vals.reshape(-1, self.width)


# ---------------------------------------------------------------------------
# chunked-reading plumbing
# ---------------------------------------------------------------------------

def iter_chunks_fallback(path: str, chunk_rows: int,
                         reader: Callable[..., Any],
                         **reader_kwargs) -> Iterator[EventFrame]:
    """Correctness fallback for formats without a chunked reader: read the
    whole file, slice into ``chunk_rows`` windows.  No memory win — the
    streaming executor still works, but peak RSS matches the eager read."""
    ev = reader(path, **reader_kwargs).events
    for lo in range(0, len(ev), chunk_rows):
        yield ev.take(np.arange(lo, min(lo + chunk_rows, len(ev))))


class StreamingTrace:
    """A trace opened out of core: a handle over (possibly sharded) paths
    that is never fully materialized.

    ``query()`` starts a lazy plan whose terminal ops execute chunk by
    chunk; registered ops are also available directly
    (``st.flat_profile()``), exactly like on an in-memory Trace.
    ``materialize()`` is the escape hatch back to a fully loaded
    :class:`~repro_torch.core.trace.Trace`.  The ops run their kernels on
    ``device`` (the card unless the caller asks for the CPU).
    """

    def __init__(self, paths, format: str = "auto",
                 chunk_rows: int = DEFAULT_CHUNK_ROWS,
                 label: Optional[str] = None, device="cuda",
                 processes: Optional[int] = None, executor: str = "auto",
                 **reader_kwargs):
        import os
        if isinstance(paths, (str, bytes)) or hasattr(paths, "__fspath__"):
            paths = [paths]
        if executor not in ("auto", "serial", "parallel"):
            raise ValueError(f'executor must be "auto", "serial" or '
                             f'"parallel", got {executor!r}')
        if processes is not None or executor == "parallel":
            raise _not_ported("the parallel executor (processes=, "
                              "executor='parallel')")
        self.paths = [os.fspath(p) for p in paths]
        self.format = format
        self.chunk_rows = int(chunk_rows)
        self.label = label or (self.paths[0] if self.paths else "stream")
        self.device = resolve_device(device)
        self.reader_kwargs = reader_kwargs
        self._stats0: Optional[StreamStats] = None
        self._ingest = IngestReport()  # filled by tolerant (on_error) reads

    # -- plumbing ----------------------------------------------------------
    def _iter_frames(self) -> Iterator[EventFrame]:
        """Chunks across all paths, in path order."""
        from .. import readers  # noqa: F401 — populate the registry
        kw = dict(self.reader_kwargs)
        if "on_error" in kw:
            # tolerant read: route per-record skip counts into this
            # handle's persistent report (readers reset their path entry
            # per pass, so multi-pass plans never double count)
            kw.setdefault("report", self._ingest)
        for p in self.paths:
            spec = registry.resolve_reader(p, self.format)
            if spec.iter_chunks is not None:
                yield from spec.iter_chunks(p, self.chunk_rows, **kw)
            else:
                yield from iter_chunks_fallback(p, self.chunk_rows,
                                                spec.read, device=self.device,
                                                **kw)

    def ingest_report(self):
        """The :class:`~repro_torch.core.errors.IngestReport` accumulated
        by tolerant (``on_error="skip"``) reads through this handle."""
        return self._ingest

    # -- materialization escape hatch --------------------------------------
    def load_raw(self):
        """Concatenate every chunk into one in-memory Trace on this
        handle's device (``_StreamSource.load``: the query engine applies
        the plan's steps to it)."""
        from .trace import Trace
        frames = list(self._iter_frames())
        ev = concat(frames) if frames else EventFrame()
        return Trace(ev, label=self.label, device=self.device)

    def materialize(self):
        """Load everything into one in-memory Trace on this handle's
        device."""
        return self.query().collect()

    # -- cheap whole-stream facts ------------------------------------------
    def stats(self) -> StreamStats:
        """One pass over the stream: event count, time span, process
        count, message-size range.  Cached."""
        if self._stats0 is None:
            self._stats0 = stats_from_frames(self._iter_frames())
        return self._stats0

    @property
    def num_processes(self) -> int:
        return self.stats().num_processes

    def __len__(self) -> int:
        return self.stats().n_events

    def __repr__(self) -> str:  # pragma: no cover
        return (f"StreamingTrace(label={self.label!r}, "
                f"{len(self.paths)} path(s), chunk_rows={self.chunk_rows}, "
                f"device={self.device})")

    # -- query / terminal ops ----------------------------------------------
    def query(self):
        from .query import TraceQuery, _StreamSource
        return TraceQuery(_StreamSource(self))

    def run(self, op_name: str, *args: Any, **kwargs: Any) -> Any:
        return self.query().run(op_name, *args, **kwargs)

    def __getattr__(self, name: str):
        return registry.terminal_op(name, self.run, "StreamingTrace")
