"""Out-of-core streaming execution of lazy query plans (paper §VI scaled).

Mirrors :mod:`repro.core.streaming`.  A trace
opened with ``Trace.open(paths, streaming=True)`` is a
:class:`StreamingTrace`: a handle over its files that is never
materialized.  A terminal op on it (or on a plan over it) runs chunk by
chunk:

* readers yield bounded EventFrames (``iter_chunks`` in the reader
  registry, or a whole-file read sliced into chunks), with the plan's
  process and time-window restriction pushed down (:class:`PlanHints`:
  shards and pack chunks it excludes are skipped unread);
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
CPU) and hands it to its ops' kernel calls.  ``processes=N`` (or
``executor="parallel"``) fans a terminal op over work units in a spawn
pool (:mod:`repro_torch.core.executor`): workers parse, mask, stitch and
buffer records on the host, the parent merges them in stream order and
makes the op's one kernel call, so every route gives the same bits.  Ops
with no streaming form raise :class:`StreamingUnsupported` naming the
escape hatches.

A :class:`LiveTrace` (``Trace.open(shards, live=True)``) runs over the
committed prefix of still-growing append-mode pack shards, pinned at its
last ``refresh()``, and its results carry a :class:`Watermark`.  A
repeated op folds only the rows committed since the last call into the
running aggregator kept in the plan cache's live store
(:mod:`repro_torch.core.plancache`); its ``result()`` then sorts and
reduces the whole record buffer in one kernel launch, as the cold pass
does, so the incremental result is the cold pass's bits.
"""

from __future__ import annotations

import copy
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, \
    Tuple

import numpy as np

from . import registry, structure
from .accel import resolve_device
from .constants import (DERIVED_COLUMNS, ENTER, ET, EXC, INC, LEAVE, MATCH,
                        NAME, PARENT, PROC, THREAD, TS)
from .errors import IngestReport
from .frame import Categorical, EventFrame, concat
from .registry import PlanHints

__all__ = ["StreamingTrace", "LiveTrace", "Watermark", "LiveResult",
           "StreamingUnsupported", "StreamAgg",
           "GlobalNames", "CallBlock", "Chunk", "StreamStats",
           "StreamContext", "CallStitcher", "execute_streaming",
           "iter_chunks_fallback", "grow_to", "fold_frames", "mask_frames",
           "stats_from_frames"]

DEFAULT_CHUNK_ROWS = 1_000_000


class StreamingUnsupported(RuntimeError):
    """A plan or op has no out-of-core form.  The message always names the
    escape hatches: ``.collect()`` (materialize, then run eagerly) or
    ``Trace.open(..., streaming=False)``."""


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
        """Code of ``name``, assigning the next one on first sight — the
        parallel executor merges the units' name tables through this, in
        unit order, which reproduces the serial first-seen codes."""
        g = self._code.get(name)
        if g is None:
            g = len(self.names)
            self._code[name] = g
            self.names.append(name)
        return g

    def code(self, name: str) -> int:
        """Code of ``name``, or -1 when no chunk has held it yet."""
        return self._code.get(name, -1)

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

    Aggregators whose state also merges *across work units* set
    ``supports_parallel = True`` and implement :meth:`merge_from`; the
    parallel executor fans exactly those over a pool.  ``update`` and
    ``merge_from`` run on the host and never touch the device (workers
    build and update aggregators); only ``result`` launches kernels.
    """

    needs_calls = False   # completed-call records (structure across chunks)
    #: declared by subclasses whose merge_from makes fan-out safe
    supports_parallel = False

    def update(self, chunk: Chunk) -> None:
        raise NotImplementedError

    def result(self, ctx: "StreamContext") -> Any:
        raise NotImplementedError

    def merge_from(self, other: "StreamAgg", code_map: np.ndarray) -> None:
        """Fold the state of ``other`` (the same aggregator class, updated
        over the next work unit in stream order) into this one;
        ``code_map[c]`` is the merged global name code of the unit's local
        code ``c``.  Only called when ``supports_parallel`` is True."""
        raise StreamingUnsupported(
            f"{type(self).__name__} declares no cross-worker merge; the op "
            f"cannot run under the parallel executor")


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

    ``defer_unmatched=True`` is the parallel-worker mode: events this
    stream prefix cannot resolve (a Leave whose Enter lives in an earlier
    work unit, and chunk-top call time owed to a call opened upstream) are
    recorded as *seam events* instead of being dropped, and the parent
    executor replays them against the carry stacks of the preceding units.
    A chunk that carries the pack sidecar's row-localized structure
    (:meth:`_precomputed`) is stitched from it without deriving again.
    """

    def __init__(self, defer_unmatched: bool = False):
        self._stacks: Dict[int, List[_Frame]] = {}
        self._last_ts: Dict[int, float] = {}
        self._first_ts: Dict[int, float] = {}
        self._defer = defer_unmatched
        # per group, in event order: ("a", inc) = attribute inc to the
        # innermost call open upstream; ("l", ts, proc) = a Leave closing
        # the innermost call open upstream
        self._seams: Dict[int, List[tuple]] = {}

    # -- public ------------------------------------------------------------
    def push_chunk(self, ev: EventFrame, gcodes: np.ndarray) -> CallBlock:
        n = len(ev)
        if n == 0:
            return CallBlock(*[np.empty(0, np.int64)] * 2,
                             *[np.empty(0, np.float64)] * 4)
        gkey = self._group_key_rows(ev)
        ts = np.asarray(ev[TS], np.float64)
        self._check_sorted(gkey, ts)

        pre = self._precomputed(ev)
        if pre is not None:
            matching, parent, inc, exc = pre
        else:
            # a serial stream's chunk starts inside calls opened before it:
            # match what opens and closes in it here, not one call at a
            # time on the carry stacks.  A deferring unit derives as the
            # reference does, so its seam events are the reference's
            matching, _depth, parent, inc, exc = \
                structure.derive_structure(ev, open_head=not self._defer)

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

    # -- parallel-worker exports -------------------------------------------
    def seams(self) -> Dict[int, List[tuple]]:
        """Per-group seam events deferred to upstream units (worker mode)."""
        return self._seams

    def trailing(self) -> Dict[int, List[Tuple[int, int, float, float]]]:
        """Per-group open frames at the end of this unit, innermost last:
        (name code, proc, start ts, accumulated child inclusive ns)."""
        return {g: [(f.name, f.proc, f.start, f.child_inc) for f in st]
                for g, st in self._stacks.items() if st}

    def group_span(self) -> Tuple[Dict[int, float], Dict[int, float]]:
        """Per-group (first, last) event timestamps seen — the parent
        executor checks cross-unit time order with these."""
        return dict(self._first_ts), dict(self._last_ts)

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
            g = int(g_s[i])
            if g not in self._first_ts:
                self._first_ts[g] = float(t_s[i])
            last = self._last_ts.get(g)
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
        if len(boundary) == 0 and not self._stacks and not (
                self._defer and len(top_ent)):
            # nothing to stitch.  A deferring unit still owes the time of
            # its chunk-top calls to the call open upstream, even in a
            # chunk without boundary events (the reference returns here
            # and loses it: ROADMAP §C)
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
                if counts[k]:
                    if stack:
                        stack[-1].child_inc += float(sums[k])
                    elif self._defer:
                        # belongs to whatever call is open in an earlier
                        # work unit — replayed by the parent at the seam
                        self._seams.setdefault(g, []).append(
                            ("a", float(sums[k])))

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
                    elif self._defer:
                        # the completed call's parent is open upstream
                        self._seams.setdefault(g, []).append(("a", c_inc))
                elif self._defer:
                    # a Leave whose Enter lives in an earlier unit: the
                    # parent pops the matching upstream carry frame
                    self._seams.setdefault(g, []).append(
                        ("l", float(ts[r]), int(procs[r])))
                # else: a leave with no open call anywhere upstream — the
                # in-memory matcher leaves it unmatched too; ignore
                attribute(k + 1)
            if not stack:
                self._stacks.pop(g, None)
        return completed

    @staticmethod
    def _precomputed(ev: EventFrame
                     ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                         np.ndarray, np.ndarray]]:
        """Chunk-localized structure the reader attached (pack sidecar
        slices: partners and parents outside the chunk are -1, exactly the
        within-chunk result ``derive_structure`` would give), or None.
        Readers never attach these columns to a row-filtered chunk, and
        ``mask_frames`` strips them before masking."""
        if not (MATCH in ev and PARENT in ev and INC in ev and EXC in ev):
            return None
        return (np.asarray(ev.column(MATCH), np.int64),
                np.asarray(ev.column(PARENT), np.int64),
                np.asarray(ev.column(INC), np.float64),
                np.asarray(ev.column(EXC), np.float64))

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


def _steps_hints(steps: Sequence) -> PlanHints:
    """Reader pushdown from the plan: the conjunction of process
    restrictions plus the intersection of within-trimmed windows."""
    from .query import SliceTimeStep
    bounds = None
    pset = None
    window = None
    for step in steps:
        b, s = step.proc_hint()
        if b is not None:
            bounds = b if bounds is None else (max(bounds[0], b[0]),
                                               min(bounds[1], b[1]))
        if s is not None:
            pset = s if pset is None else (pset & s)
        if isinstance(step, SliceTimeStep) and step.trim == "within":
            window = ((step.start, step.end) if window is None else
                      (max(window[0], step.start), min(window[1], step.end)))
    return PlanHints(procs=pset, proc_bounds=bounds, time_window=window)


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
        if mask.all():
            # the chunk as it is: precomputed structure columns (pack
            # sidecar slices) stay valid when no row is dropped
            yield frame
        else:
            # a row selection invalidates row-localized structure the
            # reader attached: strip it, so the stitcher derives on the
            # selected rows
            yield frame.drop(*DERIVED_COLUMNS).mask(mask)


def _masked_chunks(handle: "StreamingTrace", steps: Sequence
                   ) -> Iterator[EventFrame]:
    yield from mask_frames(handle._iter_frames(_steps_hints(steps)), steps,
                           handle.device)


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
                      kwargs: dict, cache_flag: Optional[bool] = None
                      ) -> Any:
    """Run one registered op out of core over ``handle`` under ``steps``:
    one pass that folds every masked chunk into the op's aggregator, then
    its ``result()``.

    When the handle asks for parallel execution (``processes=N`` or
    ``executor="parallel"``) the pass fans over work units through
    :func:`repro_torch.core.executor.execute_parallel`; a degradation back
    to the serial pass always warns with its reason (spawn-unsafe
    ``__main__``, nothing to fan out, unsplittable input).

    A serial live handle (:class:`LiveTrace`) with caching on takes the
    **incremental** path: only the rows committed since the previous call
    are folded into the running aggregator kept in the plan cache's live
    store.  Where it cannot (a plan with no exact digest, a stored state
    folded past the handle's snapshot by another thread, or a fold the
    stored state refuses) it falls back to the full pass and counts it in
    :data:`INCREMENTAL_FALLBACKS`."""
    if spec.streaming is None:
        raise StreamingUnsupported(
            f"op {spec.name!r} has no combinable streaming form (it needs "
            f"the whole trace structure at once).  Materialize with "
            f".collect().{spec.name}(...) on the collected trace, or open "
            f"with streaming=False.")
    _validate_steps(steps)
    agg: StreamAgg = spec.streaming(*args, **kwargs)
    if (getattr(handle, "is_live", False) and handle.cache
            and cache_flag is not False and not handle.wants_parallel()):
        res = _execute_live_incremental(handle, steps, spec, args, kwargs,
                                        agg)
        if res is not _NO_INCREMENTAL:
            return res
        _count_fallback()
    if handle.wants_parallel():
        from . import executor
        try:
            return executor.execute_parallel(handle, steps, spec, args,
                                             kwargs, agg)
        except executor.ParallelDegraded as d:
            import warnings
            warnings.warn(
                f"parallel streaming of op {spec.name!r} degraded to "
                f"serial: {d}", RuntimeWarning, stacklevel=3)
    names = GlobalNames()
    stitcher = CallStitcher() if agg.needs_calls else None
    proc_max = fold_frames(_masked_chunks(handle, steps), agg, names,
                           stitcher)
    open_calls = (stitcher.open_calls() if stitcher
                  else (np.empty(0, np.int64), np.empty(0, np.int64)))
    return agg.result(StreamContext(names, open_calls, proc_max))


# ---------------------------------------------------------------------------
# live incremental execution (valid-up-to-row plan-cache semantics)
# ---------------------------------------------------------------------------

_NO_INCREMENTAL = object()  # sentinel: fall through to the full pass
#: live ops that asked for the incremental path and ran the full pass
INCREMENTAL_FALLBACKS = 0
_FALLBACK_LOCK = threading.Lock()


def _count_fallback() -> None:
    global INCREMENTAL_FALLBACKS
    with _FALLBACK_LOCK:
        INCREMENTAL_FALLBACKS += 1


class _LiveEntry:
    """Running aggregation state of one live plan: the aggregator, name
    interner and call stitcher, how many rows of each path are folded in,
    a fingerprint of each path's folded prefix (group count, last group's
    offset and CRC) that proves a later snapshot *extends* it, and the
    result of the last finalize (``value``, None once more rows were
    folded).  Its lock serializes polls of one plan from several lane
    threads."""

    __slots__ = ("agg", "names", "stitcher", "proc_max", "done", "marks",
                 "value", "lock")

    def __init__(self, agg: StreamAgg):
        self.agg = agg
        self.names = GlobalNames()
        self.stitcher = CallStitcher() if agg.needs_calls else None
        self.proc_max = -1
        self.done: Dict[str, int] = {}    # path -> rows already folded
        self.marks: Dict[str, tuple] = {}  # path -> prefix fingerprint
        self.value: Any = None
        self.lock = threading.Lock()


def _prefix_mark(snap: dict, rows: int) -> tuple:
    """Fingerprint of the first ``rows`` rows of a committed-prefix
    snapshot: (groups, last group's offset, last group's CRC).  ``rows``
    is a group boundary (commits land whole groups)."""
    chunks = [c for c in snap["chunks"] if c["hi"] <= rows]
    if not chunks:
        return (0, 0, 0)
    last = chunks[-1]
    return (len(chunks), int(last["offset"]), int(last["crc"]))


def _extends(entry: _LiveEntry, handle: "LiveTrace") -> bool:
    """Does every path's current snapshot extend the prefix the entry has
    folded?  False means a shard was rewritten or truncated under it: the
    partial must be dropped."""
    for p, done in entry.done.items():
        if done == 0:
            continue
        snap = handle._snapshots.get(p)
        if snap is None or snap["rows"] < done:
            return False
        if entry.marks.get(p) != _prefix_mark(snap, done):
            return False
    return True


def _execute_live_incremental(handle: "LiveTrace", steps: Sequence,
                              spec: registry.OpSpec, args: tuple,
                              kwargs: dict, agg: StreamAgg) -> Any:
    """Incremental fold over a live handle's pinned snapshots.

    The rows fed into the stored aggregator across all calls form the
    same sequence one full pass feeds (per path, rows [0, pinned) in
    order; paths in handle order), so first-seen name codes, the
    stitcher's carry state and every buffered record agree with a cold
    pass over the same committed prefix.  ``result()`` leaves the
    aggregator's state as it was (it gathers and sorts copies of the
    buffered records), so it finalizes the stored state itself, under the
    entry's lock; with no new rows the last result is returned and no
    kernel launches.  A stored state that does not extend to this
    handle's snapshot is dropped (:func:`_extends`); one that another
    thread folded past it after that check falls back to the full pass.
    """
    from . import plancache
    from ..readers.pack import iter_chunks_pack
    key = plancache.live_plan_key(handle, steps, spec, args, kwargs)
    if key is None:
        return _NO_INCREMENTAL
    entry = plancache.live_lookup(key)
    if entry is not None and type(entry.agg) is not type(agg):
        entry = None  # a key collision across aggregator classes
    if entry is not None and not _extends(entry, handle):
        plancache.live_invalidate(key)
        entry = None
    fresh = entry is None
    if fresh:
        entry = _LiveEntry(agg)
    hints = _steps_hints(steps)
    kw = {k: v for k, v in handle.reader_kwargs.items()
          if k not in ("live", "upto_rows", "report")}
    with entry.lock:
        pinned = {p: (handle._snapshots[p]["rows"]
                      if p in handle._snapshots else 0)
                  for p in handle.paths}
        if any(pinned[p] < entry.done.get(p, 0) for p in handle.paths):
            return _NO_INCREMENTAL  # folded past our snapshot meanwhile
        try:
            for p in handle.paths:
                done = entry.done.get(p, 0)
                if pinned[p] <= done:
                    continue
                frames = iter_chunks_pack(p, handle.chunk_rows, hints,
                                          row_range=(done, pinned[p]),
                                          live=True, upto_rows=pinned[p],
                                          **kw)
                pm = fold_frames(mask_frames(frames, steps, handle.device),
                                 entry.agg, entry.names, entry.stitcher)
                entry.proc_max = max(entry.proc_max, pm)
                entry.done[p] = pinned[p]
                entry.marks[p] = _prefix_mark(handle._snapshots[p],
                                              pinned[p])
                entry.value = None
        except Exception:
            # a partly folded entry is unusable: drop it.  A fresh entry's
            # failure is the op's own (the full pass would meet it too);
            # a reused one may fail on state the full pass never sees
            # (cross-path time order only broken when fed in pieces)
            plancache.live_invalidate(key)
            if fresh:
                raise
            return _NO_INCREMENTAL
        plancache.live_store(key, entry)
        if entry.value is None:
            open_calls = (entry.stitcher.open_calls() if entry.stitcher
                          else (np.empty(0, np.int64),
                                np.empty(0, np.int64)))
            entry.value = entry.agg.result(
                StreamContext(entry.names, open_calls, entry.proc_max))
        return entry.value


class Watermark:
    """Valid-up-to marker of a live read: the result covers exactly
    ``rows`` committed rows (per path in ``per_path``) with events up to
    ``ts_max``.  ``finalized`` means every shard has sealed its footer:
    nothing more will arrive."""

    __slots__ = ("rows", "ts_max", "per_path", "finalized")

    def __init__(self, per_path: Dict[str, dict]):
        self.per_path = {p: dict(w) for p, w in per_path.items()}
        self.rows = sum(w["rows"] for w in self.per_path.values())
        ts = [w["ts_max"] for w in self.per_path.values()
              if w["ts_max"] is not None]
        self.ts_max = max(ts) if ts else None
        self.finalized = (all(w["finalized"]
                              for w in self.per_path.values())
                          if self.per_path else False)

    def as_dict(self) -> dict:
        return {"rows": self.rows, "ts_max": self.ts_max,
                "finalized": self.finalized,
                "per_path": {p: dict(w) for p, w in self.per_path.items()}}

    def __repr__(self) -> str:  # pragma: no cover
        return (f"Watermark(rows={self.rows}, ts_max={self.ts_max}, "
                f"finalized={self.finalized})")


class LiveResult:
    """A live query's value and the watermark it is valid up to."""

    __slots__ = ("value", "watermark")

    def __init__(self, value: Any, watermark: Watermark):
        self.value = value
        self.watermark = watermark

    def __iter__(self):  # tuple-style unpacking: value, watermark
        return iter((self.value, self.watermark))

    def __repr__(self) -> str:  # pragma: no cover
        return f"LiveResult({self.value!r}, {self.watermark!r})"


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

    def merge(self, other: "RecordBuffer", code_map: np.ndarray) -> None:
        """Append the records of ``other`` (the next work unit's), their
        local name codes mapped into this buffer's by ``code_map``."""
        for name, proc, start, end, vals in other._parts:
            self._parts.append((code_map[name], proc, start, end, vals))

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
                         hints: Optional[PlanHints],
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

    ``processes=N`` (or ``executor="parallel"``) fans terminal ops over
    work units in the shared scheduler's spawn pool
    (:mod:`repro_torch.core.executor`, :mod:`repro_torch.core.scheduler`);
    ``cache=False`` opts this handle out of the plan-result cache
    (:mod:`repro_torch.core.plancache`).
    """

    def __init__(self, paths, format: str = "auto",
                 chunk_rows: int = DEFAULT_CHUNK_ROWS,
                 label: Optional[str] = None, device="cuda",
                 processes: Optional[int] = None, executor: str = "auto",
                 cache: bool = True, **reader_kwargs):
        import os
        if isinstance(paths, (str, bytes)) or hasattr(paths, "__fspath__"):
            paths = [paths]
        if executor not in ("auto", "serial", "parallel"):
            raise ValueError(f'executor must be "auto", "serial" or '
                             f'"parallel", got {executor!r}')
        self.paths = [os.fspath(p) for p in paths]
        self.format = format
        self.chunk_rows = int(chunk_rows)
        self.label = label or (self.paths[0] if self.paths else "stream")
        self.device = resolve_device(device)
        self.processes = processes
        self.executor = executor
        self.cache = cache
        self.reader_kwargs = reader_kwargs
        self._steps: tuple = ()
        self._stats0: Optional[StreamStats] = None
        self._pool = None  # the scheduler's SharedPool, at the first pooled op
        self._units_cache: dict = {}  # work-unit plans per (paths, workers)
        self._ingest = IngestReport()  # filled by tolerant (on_error) reads
        #: ``torch.cuda.is_initialized()`` of each unit of the last
        #: parallel run, in unit order (never True: workers stay on the
        #: host)
        self.units_cuda: List[bool] = []

    def wants_parallel(self) -> bool:
        """True when terminal ops should try the parallel executor."""
        if self.executor == "serial":
            return False
        if self.executor == "parallel":
            return True
        return self.processes is not None and self.processes > 1

    # -- plumbing ----------------------------------------------------------
    def _iter_frames(self, hints: Optional[PlanHints] = None
                     ) -> Iterator[EventFrame]:
        """Chunks across all paths, in path order, with shard skipping
        (registered ``shard_procs`` hints) and per-chunk pushdown.  Each
        chunk is a cancellation point (:func:`~repro_torch.core.
        cancellation.check_cancelled`): a request past its deadline frees
        its service lane at the next chunk."""
        from .. import readers  # noqa: F401 — populate the registry
        from ..readers.parallel import select_shards
        from .cancellation import check_cancelled
        procs = set(hints.procs) if hints and hints.procs is not None \
            else None
        bounds = hints.proc_bounds if hints else None
        paths = select_shards(self.paths, self.format, procs=procs,
                              proc_bounds=bounds)
        kw = dict(self.reader_kwargs)
        if "on_error" in kw:
            # tolerant read: route per-record skip counts into this
            # handle's persistent report (readers reset their path entry
            # per pass, so multi-pass plans never double count)
            kw.setdefault("report", self._ingest)
        for p in paths:
            spec = registry.resolve_reader(p, self.format)
            if spec.iter_chunks is not None:
                frames = spec.iter_chunks(p, self.chunk_rows, hints, **kw)
            else:
                frames = iter_chunks_fallback(p, self.chunk_rows, hints,
                                              spec.read, device=self.device,
                                              **kw)
            for frame in frames:
                check_cancelled()
                yield frame

    def iter_chunks(self) -> Iterator[EventFrame]:
        """Chunk frames with this handle's plan steps applied (masks fused
        per chunk)."""
        yield from _masked_chunks(self, self._steps)

    def ingest_report(self):
        """The :class:`~repro_torch.core.errors.IngestReport` accumulated
        by tolerant (``on_error="skip"``) reads through this handle."""
        return self._ingest

    def with_steps(self, steps: Sequence) -> "StreamingTrace":
        """Shallow copy carrying plan ``steps``, sharing this handle's
        worker pool, unit plans and ingest report."""
        clone = StreamingTrace(self.paths, format=self.format,
                               chunk_rows=self.chunk_rows, label=self.label,
                               device=self.device, processes=self.processes,
                               executor=self.executor, cache=self.cache,
                               **self.reader_kwargs)
        clone._steps = tuple(steps)
        clone._pool = self._pool
        clone._units_cache = self._units_cache  # same paths, same plans
        clone._ingest = self._ingest  # one report per logical handle
        return clone

    # -- materialization escape hatch --------------------------------------
    def load_raw(self, procs=None, proc_bounds=None):
        """Concatenate every chunk into one in-memory Trace on this
        handle's device *without* its plan steps (``_StreamSource.load``:
        the query engine applies them); shards the process restriction
        excludes are skipped."""
        from .trace import Trace
        hints = PlanHints(
            procs=frozenset(procs) if procs is not None else None,
            proc_bounds=proc_bounds)
        # chunked readers may attach chunk-localized structure columns
        # (pack sidecar); their indices are meaningless after concat
        frames = [f.drop(*DERIVED_COLUMNS) for f in self._iter_frames(hints)]
        ev = concat(frames) if frames else EventFrame()
        return Trace(ev, label=self.label, device=self.device)

    def materialize(self):
        """Load everything into one in-memory Trace on this handle's
        device (this handle's plan steps applied)."""
        return self.query().collect()

    # -- conversion ---------------------------------------------------------
    def save_pack(self, path: str, chunk_rows: Optional[int] = None,
                  sidecar: bool = True) -> str:
        """Convert this handle's stream (its plan steps applied) to the
        columnar pack format (:mod:`repro_torch.readers.pack`) without
        materializing it; ``sidecar=True`` also stores the structure
        sidecar, from one memmap-backed pass over the written columns.
        Returns ``path``."""
        from ..readers.pack import DEFAULT_PACK_CHUNK_ROWS, PackWriter
        with PackWriter(path, chunk_rows=chunk_rows or
                        DEFAULT_PACK_CHUNK_ROWS) as w:
            for frame in self.iter_chunks():
                w.append(frame.drop(*DERIVED_COLUMNS))
            return w.finish(sidecar=sidecar)

    # -- cheap whole-stream facts ------------------------------------------
    def stats(self) -> StreamStats:
        """One pass over the (selection-masked) stream: event count, time
        span, process count.  Cached."""
        if self._stats0 is None:
            self._stats0 = stats_from_frames(self.iter_chunks())
        return self._stats0

    @property
    def num_processes(self) -> int:
        return self.stats().num_processes

    def __len__(self) -> int:
        return self.stats().n_events

    def __repr__(self) -> str:  # pragma: no cover
        return (f"StreamingTrace(label={self.label!r}, "
                f"{len(self.paths)} path(s), chunk_rows={self.chunk_rows}, "
                f"steps={len(self._steps)}, device={self.device})")

    # -- query / terminal ops ----------------------------------------------
    def query(self):
        from .query import TraceQuery, _StreamSource
        return TraceQuery(_StreamSource(self), self._steps)

    def run(self, op_name: str, *args: Any, **kwargs: Any) -> Any:
        return self.query().run(op_name, *args, **kwargs)

    def __getattr__(self, name: str):
        return registry.terminal_op(name, self.run, "StreamingTrace")


class LiveTrace(StreamingTrace):
    """A still-growing trace opened live: plans run over the **committed
    prefix** pinned at the last :meth:`refresh`, and results carry a
    :class:`Watermark` saying how far they are valid.

    The handle snapshots each shard's committed prefix (group index and
    name table) when created and on every ``refresh()``; every read
    (serial, parallel row-span units, stats) is pinned to that snapshot, so
    a writer committing mid-query cannot leak rows into the result, and the
    eager, streamed and parallel routes give the same bits on the prefix.
    With caching on (the default), a repeated op folds only the rows
    committed since the previous call (:func:`execute_streaming`).  The
    ops run their kernels on ``device``.

    A shard that does not exist yet, or has no committed group, reads as
    empty: a live pipeline whose data has not arrived is not an error.
    """

    is_live = True

    def __init__(self, paths, format: str = "auto",
                 chunk_rows: int = DEFAULT_CHUNK_ROWS,
                 label: Optional[str] = None, device="cuda",
                 processes: Optional[int] = None, executor: str = "auto",
                 cache: bool = True, **reader_kwargs):
        if format not in ("auto", "pack"):
            raise ValueError(
                f"live=True requires pack shards (the append/commit "
                f"protocol is a pack v2 feature), got format={format!r}")
        # workers inherit live reads through reader_kwargs: a RowSpan unit
        # resolves the committed prefix, never a (missing) footer
        reader_kwargs = dict(reader_kwargs)
        reader_kwargs["live"] = True
        super().__init__(paths, format="pack", chunk_rows=chunk_rows,
                         label=label, device=device, processes=processes,
                         executor=executor, cache=cache, **reader_kwargs)
        self._snapshots: Dict[str, dict] = {}
        self.refresh()

    # -- snapshot control ----------------------------------------------------
    def refresh(self) -> Watermark:
        """Snapshot every shard's committed prefix again and return the new
        :attr:`watermark`.  Cheap on unchanged shards (the pack layer's
        incremental cursor); drops this handle's stats and work-unit
        plans, which were pinned to the old snapshot."""
        from ..readers.pack import committed_prefix
        self._snapshots = {p: committed_prefix(p) for p in self.paths}
        self._stats0 = None
        self._units_cache.clear()
        return self.watermark

    @property
    def watermark(self) -> Watermark:
        """The pinned snapshot's validity marker (per path too): what every
        result of this handle is valid up to."""
        return Watermark({p: s["watermark"]
                          for p, s in self._snapshots.items()})

    # -- pinned plumbing -----------------------------------------------------
    def _iter_frames(self, hints: Optional[PlanHints] = None
                     ) -> Iterator[EventFrame]:
        from ..readers.pack import iter_chunks_pack
        from .cancellation import check_cancelled
        kw = {k: v for k, v in self.reader_kwargs.items()
              if k not in ("live", "upto_rows")}
        for p in self.paths:
            snap = self._snapshots.get(p)
            pinned = snap["rows"] if snap else 0
            if pinned == 0:
                continue
            for frame in iter_chunks_pack(p, self.chunk_rows, hints,
                                          live=True, upto_rows=pinned,
                                          **kw):
                check_cancelled()
                yield frame

    def plan_units_for(self, path: str, n_units: int) -> List[Any]:
        """Work units for one shard, bounded by the pinned snapshot:
        RowSpans on committed group boundaries.  The parallel planner uses
        these in place of the registry's (whose footer read fails on an
        unfinalized shard, and whose whole-path unit would read past the
        watermark)."""
        snap = self._snapshots.get(path)
        chunks = snap["chunks"] if snap else []
        if not chunks:
            return []
        if n_units <= 1 or len(chunks) == 1:
            return [registry.RowSpan(path, 0, chunks[-1]["hi"])]
        groups = registry.even_groups(chunks, n_units)
        return [registry.RowSpan(path, g[0]["lo"], g[-1]["hi"])
                for g in groups]

    def with_steps(self, steps: Sequence) -> "LiveTrace":
        """Clone carrying plan ``steps`` that **shares this handle's pinned
        snapshots** (by reference)."""
        clone = copy.copy(self)
        clone._steps = tuple(steps)
        clone._stats0 = None
        return clone

    # -- watermarked results -------------------------------------------------
    def run_with_watermark(self, op_name: str, *args: Any,
                           **kwargs: Any) -> LiveResult:
        """Run a terminal op and return ``LiveResult(value, watermark)``,
        the watermark of the pinned snapshot the run covered."""
        wm = self.watermark
        return LiveResult(self.query().run(op_name, *args, **kwargs), wm)

    def __repr__(self) -> str:  # pragma: no cover
        wm = self.watermark
        return (f"LiveTrace(label={self.label!r}, {len(self.paths)} "
                f"path(s), rows={wm.rows}, finalized={wm.finalized}, "
                f"device={self.device})")
