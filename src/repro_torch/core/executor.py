"""Multi-core execution of streaming plans (paper §VI scaled out).

Mirrors :mod:`repro.core.executor`.  The serial streaming pass
(:mod:`repro_torch.core.streaming`) parses, masks and stitches every chunk
in one Python process; this module fans the same pipeline over a spawn
pool:

* **unit planning** — the input is partitioned into work units in stream
  order: whole shard paths, byte ranges of line-oriented files
  (:class:`~repro_torch.core.registry.ByteSpan`), row ranges of pack
  files (:class:`~repro_torch.core.registry.RowSpan`) or process subsets
  (:class:`~repro_torch.core.registry.ProcSpan`, the chrome and otf2j
  planners', enforced with an explicit mask; units a process-restricted
  plan cannot need are pruned before any worker reads them);
* **worker fold** — each unit runs the serial pipeline (pushdown hints →
  fused mask per chunk → the op's aggregator), its
  :class:`~repro_torch.core.streaming.CallStitcher` in *deferred* mode:
  events a unit cannot resolve (a Leave whose Enter lives in an earlier
  unit, call time owed to a call opened upstream) come back as **seam
  events**.  Workers run on the host only: they never initialize CUDA;
* **merge** — the parent interns the units' name tables in unit order
  (the serial first-seen codes), folds each unit's aggregator in through
  its ``merge_from`` (name codes remapped, buffered records appended), and
  replays the seam events against the carry stacks of the preceding
  units, so calls split across unit seams complete with the inclusive and
  exclusive times the serial stitcher gives them.  Units are merged as
  they arrive, in unit order, and then dropped.

With the handle's ``fold="once"`` the aggregators buffer records and make
one kernel call in ``result()``, on the parent's device, after the
canonical record sort: the same record multiset reaches the kernel in the
same order on every route, so the parallel route gives the serial route's
bits.  With ``fold="chunks"`` a worker holds each chunk's records on the
host and the parent folds them on the card as the unit arrives, one launch
a chunk, into its bounded state (:class:`~repro_torch.core.streaming.
FoldAgg`); peak memory then holds the units in flight, not the stream.
An aggregator that needs global bin edges gets them from the statistics
pre-pass, itself fanned over the pool (:func:`parallel_stats`, a
``"stats"`` payload a unit, merged in unit order).

A degradation back to the serial pass raises :class:`ParallelDegraded`;
``execute_streaming`` turns it into a ``RuntimeWarning`` naming the reason.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from . import registry
from .constants import ENTER, ET, INSTANT, LEAVE, NAME, PROC, TS
from .frame import Categorical, EventFrame
from .streaming import (CallBlock, CallStitcher, Chunk, GlobalNames,
                        StreamAgg, StreamContext, StreamingUnsupported,
                        StreamStats, _steps_hints, fold_frames,
                        iter_chunks_fallback, make_agg, mask_frames,
                        stats_from_frames)
from ..parallel_util import resolve_processes, spawn_unsafe_reason

__all__ = ["execute_parallel", "parallel_stats", "plan_units",
           "ParallelDegraded"]


class ParallelDegraded(RuntimeError):
    """Parallel execution is not applicable; fall back to serial streaming.
    The message is the user-facing reason (it ends up in a warning)."""


# ---------------------------------------------------------------------------
# unit planning
# ---------------------------------------------------------------------------

def _stat(p: str) -> tuple:
    """(size, mtime) of a file; of a directory archive (otf2j) the sum of
    its files' sizes, their latest mtime and their count, so a file
    rewritten inside it is planned again."""
    try:
        if os.path.isdir(p):
            size = mtime = n = 0
            for root, _dirs, files in os.walk(p):
                for fn in files:
                    st = os.stat(os.path.join(root, fn))
                    size += st.st_size
                    mtime = max(mtime, st.st_mtime_ns)
                    n += 1
            return (size, mtime, n)
        st = os.stat(p)
        return (st.st_size, st.st_mtime_ns)
    except OSError:
        return (-1, -1)


def plan_units(handle, steps: Sequence, n_workers: int) -> List[Any]:
    """Partition the handle's (shard-skipped) input into work units, in
    stream order — path order, spans in offset order — which is what makes
    the seam replay equivalent to the serial chunk sequence.  A unit is a
    whole path (str), a ByteSpan, a RowSpan or a ProcSpan.  A handle with a
    ``plan_units_for(path, n)`` method (a live handle) plans each path
    itself.

    Plans are memoized on the handle per (selected paths with their size
    and mtime, n_workers): a file that grows between ops is planned
    again."""
    from .. import readers  # noqa: F401 — populate the registry
    from ..readers.parallel import select_shards
    hints = _steps_hints(steps)
    procs = set(hints.procs) if hints.procs is not None else None
    paths = select_shards(handle.paths, handle.format, procs=procs,
                          proc_bounds=hints.proc_bounds)
    if not paths:
        return []
    cache_key = (tuple((p,) + _stat(p) for p in paths), n_workers)
    if cache_key in handle._units_cache:
        return handle._units_cache[cache_key]
    sizes = [max(_stat(p)[0], 0) for p in paths]
    total = max(sum(sizes), 1)
    units: List[Any] = []
    planner = getattr(handle, "plan_units_for", None)
    for p, sz in zip(paths, sizes):
        # a share of the worker budget proportional to file size
        want = max(1, round(sz * n_workers / total))
        if planner is not None:
            # handle-owned planning (live handles): its units are the
            # plan even when there is one, since a whole-path unit would
            # read past the pinned snapshot
            units.extend(planner(p, want))
            continue
        spec = registry.resolve_reader(p, handle.format)
        sub = None
        if want > 1 and spec.plan_units is not None:
            sub = spec.plan_units(p, want)
        if sub and len(sub) > 1:
            units.extend(sub)
        else:
            units.append(p)
    handle._units_cache[cache_key] = units
    return units


# ---------------------------------------------------------------------------
# worker side
# ---------------------------------------------------------------------------

def _unit_frames(unit, fmt: str, chunk_rows: int,
                 hints: Optional[registry.PlanHints],
                 reader_kwargs: dict) -> Iterator[EventFrame]:
    """Raw chunk frames of one work unit (pushdown hints applied)."""
    if isinstance(unit, registry.ByteSpan):
        spec = registry.resolve_reader(unit.path, fmt)
        yield from spec.iter_chunks(unit.path, chunk_rows, hints,
                                    byte_range=(unit.lo, unit.hi),
                                    **reader_kwargs)
        return
    if isinstance(unit, registry.RowSpan):
        spec = registry.resolve_reader(unit.path, fmt)
        yield from spec.iter_chunks(unit.path, chunk_rows, hints,
                                    row_range=(unit.lo, unit.hi),
                                    **reader_kwargs)
        return
    if isinstance(unit, registry.ProcSpan):
        spec = registry.resolve_reader(unit.path, fmt)
        pset = frozenset(unit.procs)
        if hints is not None and hints.procs is not None:
            pset = pset & hints.procs
        sub = registry.PlanHints(
            procs=pset,
            proc_bounds=hints.proc_bounds if hints else None,
            time_window=hints.time_window if hints else None)
        kw = dict(unit.extra)
        kw.update(reader_kwargs)
        parr = np.asarray(sorted(pset), np.int64)
        for frame in spec.iter_chunks(unit.path, chunk_rows, sub, **kw):
            # hints are advisory; the unit's process subset is a partition
            # contract, so it is enforced here
            m = np.isin(np.asarray(frame[PROC], np.int64), parr)
            yield frame if m.all() else frame.mask(m)
        return
    spec = registry.resolve_reader(unit, fmt)
    if spec.iter_chunks is not None:
        yield from spec.iter_chunks(unit, chunk_rows, hints, **reader_kwargs)
    else:
        yield from iter_chunks_fallback(unit, chunk_rows, hints, spec.read,
                                        device="cpu", **reader_kwargs)


class _UnitResult:
    """What one worker sends back: its name table (first-seen order), the
    updated aggregator, and — for call-stitching ops — the seam events,
    trailing open frames and per-group time span; ``cuda_initialized``
    says whether the worker's process had initialized CUDA (it never
    should)."""

    __slots__ = ("names", "agg", "proc_max", "seams", "trailing",
                 "first_ts", "last_ts", "cuda_initialized")

    def __init__(self, names, agg, proc_max, seams, trailing, first_ts,
                 last_ts, cuda_initialized):
        self.names = names
        self.agg = agg
        self.proc_max = proc_max
        self.seams = seams
        self.trailing = trailing
        self.first_ts = first_ts
        self.last_ts = last_ts
        self.cuda_initialized = cuda_initialized

    def __getstate__(self):
        return {s: getattr(self, s) for s in self.__slots__}

    def __setstate__(self, state):
        for s in self.__slots__:
            setattr(self, s, state[s])


def _run_unit(payload):
    """Pool worker: one unit through the serial streaming pipeline, on the
    host — the aggregator's ``device`` is only carried, and the masks and
    the stitcher run in NumPy.  ``mode="stats"`` returns the unit's
    :class:`StreamStats` partial; ``mode="fold"`` folds the unit into the
    op's aggregator (a ``fold="chunks"`` one holds each chunk's records
    for the parent) and returns a :class:`_UnitResult`."""
    (mode, unit, fmt, chunk_rows, reader_kwargs, steps, name, factory, args,
     kwargs, fold, stats, *rest) = payload
    label = rest[0] if rest else None  # the handle's, for the step masks
    from ..readers import parallel as _rp
    _rp._ensure_registered()
    frames = mask_frames(
        _unit_frames(unit, fmt, chunk_rows, _steps_hints(steps),
                     reader_kwargs), steps, label, device="cpu")
    if mode == "stats":
        return stats_from_frames(frames)
    agg: StreamAgg = make_agg(name, factory, args, kwargs, fold)
    agg.deferred = True
    agg.begin(stats)
    names = GlobalNames()
    stitcher = CallStitcher(defer_unmatched=True) if agg.needs_calls else None
    proc_max = fold_frames(frames, agg, names, stitcher)
    cuda = bool(torch.cuda.is_initialized())
    if stitcher is not None:
        first_ts, last_ts = stitcher.group_span()
        return _UnitResult(names.names, agg, proc_max, stitcher.seams(),
                           stitcher.trailing(), first_ts, last_ts, cuda)
    return _UnitResult(names.names, agg, proc_max, {}, {}, {}, {}, cuda)


# ---------------------------------------------------------------------------
# parent side: merge
# ---------------------------------------------------------------------------

def _empty_events() -> EventFrame:
    """Canonical zero-row frame carrying seam-completed calls into an
    aggregator update."""
    return EventFrame({
        TS: np.asarray([], np.int64),
        ET: Categorical.from_codes(np.asarray([], np.int32),
                                   np.asarray([ENTER, LEAVE, INSTANT])),
        NAME: Categorical.from_codes(np.asarray([], np.int32),
                                     np.asarray([], dtype=object)),
        PROC: np.asarray([], np.int64),
    })


def _merge_results(agg: StreamAgg, results: Iterator[_UnitResult],
                   units_cuda: List[bool]) -> Any:
    """Fold worker results, in unit order and each as it arrives, into
    ``agg`` and return its result (the op's one kernel call, or the fold
    state's assembly, on ``agg``'s device); each unit's
    ``torch.cuda.is_initialized()`` is appended to ``units_cuda``."""
    names = GlobalNames()
    proc_max = -1
    # per-group carry stacks across unit seams: [name, proc, start, child_inc]
    prefix: Dict[int, List[list]] = {}
    last_ts: Dict[int, float] = {}
    for r in results:
        units_cuda.append(r.cuda_initialized)
        code_map = np.asarray([names.intern(str(s)) for s in r.names],
                              np.int64)
        for g, ft in r.first_ts.items():
            lt = last_ts.get(g)
            if lt is not None and ft < lt:
                raise StreamingUnsupported(
                    "streaming execution needs each (process, thread) event "
                    "stream in non-decreasing time order across parallel "
                    "work units; this trace interleaves out of order.  "
                    "Re-shard it or open with streaming=False.")
        for g, lt in r.last_ts.items():
            if lt > last_ts.get(g, -np.inf):
                last_ts[g] = lt
        # replay this unit's seam events against the upstream carry stacks
        completed: List[tuple] = []
        for g, items in r.seams.items():
            stack = prefix.setdefault(g, [])
            for item in items:
                if item[0] == "a":
                    if stack:
                        stack[-1][3] += item[1]
                    # no open call upstream: the serial stitcher drops the
                    # attribution too
                elif stack:
                    _tag, ts_, _proc = item
                    nm, pc, st_, ci = stack.pop()
                    inc = ts_ - st_
                    completed.append((nm, pc, st_, ts_, inc, inc - ci))
                    if stack:
                        stack[-1][3] += inc
                # else: a Leave with no open call anywhere — unmatched on
                # the serial route as well; ignore
        # trailing open frames stack on top for the next units (name codes
        # remapped into the merged space now, so later pops need no map)
        for g, frames_ in r.trailing.items():
            stack = prefix.setdefault(g, [])
            for nm, pc, st_ts, ci in frames_:
                stack.append([int(code_map[nm]), int(pc), float(st_ts),
                              float(ci)])
        agg.merge_from(r.agg, code_map)
        if completed:
            cn, cp, cs, ce, ci_, cx = (np.asarray(c)
                                       for c in zip(*completed))
            block = CallBlock(cn.astype(np.int64), cp.astype(np.int64),
                              cs.astype(np.float64), ce.astype(np.float64),
                              ci_.astype(np.float64), cx.astype(np.float64))
            agg.update(Chunk(_empty_events(), np.empty(0, np.int64), block,
                             names))
        proc_max = max(proc_max, r.proc_max)
    open_frames = [f for st in prefix.values() for f in st]
    open_calls = (np.asarray([f[0] for f in open_frames], np.int64),
                  np.asarray([f[1] for f in open_frames], np.int64))
    return agg.result(StreamContext(names, open_calls, proc_max))


def _prune_units(units: List[Any], hints: registry.PlanHints) -> List[Any]:
    """Drop the ProcSpan units whose process set the plan's restriction
    can never admit: their workers would decode the whole stream only to
    mask every row away.  Safe because ProcSpan sets partition the rows."""
    if hints.procs is None and hints.proc_bounds is None:
        return units
    return [u for u in units
            if not isinstance(u, registry.ProcSpan)
            or any(hints.admits_proc(p) for p in u.procs)]


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def _pool_mapper(handle, use_pool: bool):
    """``mapper(payloads)`` over the handle's pool (ordered, lazy) or
    in-process; raises :class:`ParallelDegraded` when no pool can run."""
    if not use_pool:
        return lambda payloads: (_run_unit(p) for p in payloads)
    reason = spawn_unsafe_reason()
    if reason is not None:
        raise ParallelDegraded(reason)
    if handle._pool is None:
        # the shared scheduler owns the pools: every handle (and every
        # service session) asking for n workers fans into one pool
        from .scheduler import get_scheduler
        handle._pool = get_scheduler().spawn_pool(
            resolve_processes(handle.processes))
    try:
        handle._pool.get()
    except RuntimeError as e:  # pragma: no cover - raced __main__ state
        raise ParallelDegraded(str(e)) from None
    return lambda payloads: handle._pool.imap(_run_unit, payloads)


def _units(handle, steps: Sequence, n: int) -> List[Any]:
    planned = plan_units(handle, steps, n)
    units = _prune_units(planned, _steps_hints(steps))
    handle.units_pruned = len(planned) - len(units)
    if len(units) <= 1:
        raise ParallelDegraded(
            "the input cannot be partitioned into more than one work unit "
            "(single file with no registered unit planner, or everything "
            "was pruned by shard skipping / the plan's process "
            "restriction)")
    return units


def _stats_payloads(handle, steps: Sequence, units: List[Any]) -> list:
    return [("stats", u, handle.format, handle.chunk_rows,
             handle.reader_kwargs, tuple(steps), None, None, (), {},
             "once", None, handle.label) for u in units]


def _merged_stats(parts) -> StreamStats:
    stats = StreamStats()
    for part in parts:
        stats.merge(part)
    return stats


def parallel_stats(handle, steps: Sequence, n_units: Optional[int] = None,
                   use_pool: bool = True) -> StreamStats:
    """The statistics pre-pass over work units in the handle's pool, on
    the host, merged in unit order.  Raises :class:`ParallelDegraded` when
    fan-out does not apply; the caller (``StreamingTrace.stats``) then
    runs the serial pass without a warning, since a stats pass has no
    mode choice to warn about.  ``n_units`` / ``use_pool=False`` are
    :func:`execute_parallel`'s test hooks."""
    n = resolve_processes(handle.processes)
    if use_pool and n <= 1:
        raise ParallelDegraded("processes=1 leaves nothing to fan out")
    units = _units(handle, steps, n_units or n)
    mapper = _pool_mapper(handle, use_pool)
    return _merged_stats(mapper(_stats_payloads(handle, steps, units)))


def execute_parallel(handle, steps: Sequence, spec: registry.OpSpec,
                     args: tuple, kwargs: dict, agg: StreamAgg,
                     n_units: Optional[int] = None,
                     use_pool: bool = True) -> Any:
    """Fan one streaming op over work units and merge the partials.

    Raises :class:`ParallelDegraded` (with the user-facing reason) when
    multi-core execution is not applicable; the caller falls back to the
    serial pass and warns.  ``n_units`` / ``use_pool=False`` are test
    hooks: they force a unit count and run the units in-process, which
    exercises the seam machinery without a pool.  An aggregator that
    needs the statistics pre-pass gets it over the same units first (or
    the handle's cached stats when the plan adds no steps)."""
    if not getattr(agg, "supports_parallel", False):
        raise ParallelDegraded(
            f"op {spec.name!r} has a streaming form but no cross-worker "
            f"merge declaration (aggregator {type(agg).__name__}); it runs "
            f"serially")
    n = resolve_processes(handle.processes)
    if use_pool and n <= 1:
        raise ParallelDegraded("processes=1 leaves nothing to fan out")
    units = _units(handle, steps, n_units or n)
    mapper = _pool_mapper(handle, use_pool)
    stats = None
    if agg.needs_stats:
        same = tuple(steps) == tuple(handle._steps)
        if same and handle._stats0 is not None:
            stats = handle._stats0
        else:
            stats = _merged_stats(mapper(_stats_payloads(handle, steps,
                                                         units)))
            if same:
                handle._stats0 = stats
    agg.begin(stats)
    # workers never see a torch.device: they must not touch torch.cuda
    wkw = {k: (str(v) if k == "device" else v) for k, v in kwargs.items()}
    payloads = [("fold", u, handle.format, handle.chunk_rows,
                 handle.reader_kwargs, tuple(steps), spec.name,
                 spec.streaming, args, wkw, handle.fold, stats, handle.label)
                for u in units]
    handle.units_cuda = []
    return _merge_results(agg, mapper(payloads), handle.units_cuda)
