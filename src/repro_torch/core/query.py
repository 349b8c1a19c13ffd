"""Lazy, composable query plans over traces (paper §IV-E, §VII).

The eager ``Trace`` methods materialize a sub-frame per call and throw away
all derived structure (enter/leave matching, parents, depth, inc/exc), so a
chain like ``trace.filter(a).slice_time(x, y).filter_processes(...)`` pays N
full-column copies and re-runs the matching machinery on the next analysis
op.  ``TraceQuery`` instead records the chain as a small logical plan and
executes it on the first terminal op:

* **mask fusion** — consecutive row-selection steps evaluate to boolean
  masks on the *same* frame and are AND-ed into one mask applied once per
  column, so an N-step chain materializes one sub-frame, not N;
* **structure reuse** — when a selection keeps enter/leave pairs and parent
  chains intact (process subsets, whole-call-interval windows), the derived
  index columns are *remapped* through the old→new row map instead of being
  recomputed (no lexsorts); inclusive/exclusive metrics are recomputed with
  the same O(N) kernel the eager path uses, so results are bit-identical.
  When pairs are actually broken the plan falls back to a full recompute;
* **op registry** — every analysis op is a terminal method on the query
  (resolved through :mod:`repro_torch.core.registry`), and its declared
  prerequisites (structure / message matching) are materialized exactly once
  per plan; the op runs its kernels on the source's ``device`` unless the
  terminal is given another ``device=``.

Mirrors :mod:`repro.core.query`.  Selections happen on the host and keep
the source trace's ``device``, so a sub-trace never changes device behind
the caller's back.  Plans over a
:class:`~repro_torch.core.streaming.StreamingTrace` execute chunk by chunk;
plans over unread shards (:func:`scan`) read them at collect time, after
the plan's process restriction is known, so shards it excludes are never
parsed.  Terminal results of streaming and scan sources are memoized in
the plan-result cache (:mod:`repro_torch.core.plancache`); an in-memory
trace joins it per call with ``cache=True``.

Example::

    (trace.query()
          .slice_time(t0, t1)                 # call-interval window
          .filter(Filter("Name", "not-in", ["MPI_Wait"]))
          .restrict_processes(range(8))
          .flat_profile())                    # plan executes here
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from . import registry, structure
from .accel import resolve_device
from .constants import (CCT_NODE, DERIVED_COLUMNS, ENTER, ET, EXC, INC,
                        LEAVE, MATCH, MATCH_TS, MPI_RECV, MPI_SEND, NAME,
                        PARENT, PROC, TS)
from .filters import Filter, _And, _Not, _Or
from .frame import EventFrame

__all__ = ["TraceQuery", "scan"]


# ---------------------------------------------------------------------------
# plan steps
# ---------------------------------------------------------------------------

class Step:
    """One row-selection step of a logical plan."""

    def needs_structure(self) -> bool:
        """True when this step's mask reads matching timestamps (overlap
        windows).  Such a step can still fuse past pair-preserving pending
        selections, which keep per-row (ts, match_ts) intact."""
        return False

    def reads_derived(self) -> bool:
        """True when this step's mask reads derived *value* columns
        (inc/exc/depth/parent/...), whose contents change with the selection
        itself — forcing an unconditional materialization barrier so the
        predicate sees the same recomputed values the eager chain sees."""
        return False

    def mask(self, trace) -> np.ndarray:
        raise NotImplementedError

    def proc_hint(self):
        """(bounds, explicit_set) restriction this step puts on Process."""
        return None, None

    def describe(self) -> str:
        raise NotImplementedError


class FilterStep(Step):
    """A plain row predicate.  Overlap-trimmed time windows never reach this
    step type — _decompose_filter turns them into SliceTimeStep."""

    def __init__(self, f: Filter):
        self.filter = f

    def reads_derived(self) -> bool:
        return bool(self.filter.columns() & set(DERIVED_COLUMNS))

    def mask(self, trace) -> np.ndarray:
        return np.asarray(self.filter.mask(trace.events), bool)

    def proc_hint(self):
        return self.filter.process_bounds(), None

    def describe(self) -> str:
        return f"filter {self.filter!r}"


class SliceTimeStep(Step):
    def __init__(self, start: float, end: float, trim: str = "overlap"):
        if trim not in ("overlap", "within"):
            raise ValueError(f'trim must be "overlap" or "within", got {trim!r}')
        self.start, self.end, self.trim = start, end, trim

    def needs_structure(self) -> bool:
        return self.trim == "overlap"

    def mask(self, trace) -> np.ndarray:
        ts = np.asarray(trace.events[TS], np.float64)
        if self.trim == "within":
            return (ts >= self.start) & (ts <= self.end)
        return _overlap_mask(trace, self.start, self.end)

    def describe(self) -> str:
        return f"slice_time [{self.start:g}, {self.end:g}] trim={self.trim}"


class ProcessStep(Step):
    def __init__(self, procs: Sequence[int]):
        self.procs = np.unique(np.asarray(list(procs), np.int64))

    def mask(self, trace) -> np.ndarray:
        return np.isin(np.asarray(trace.events[PROC], np.int64), self.procs)

    def proc_hint(self):
        return None, frozenset(int(p) for p in self.procs)

    def describe(self) -> str:
        return f"restrict_processes {list(map(int, self.procs))}"


def _overlap_mask(trace, start: float, end: float) -> np.ndarray:
    """Events whose call interval [min(ts, match_ts), max(...)] overlaps the
    window — identical arithmetic to the eager Trace.slice_time."""
    ev = trace.events
    ts = np.asarray(ev[TS], np.float64)
    mts = np.asarray(ev.column(MATCH_TS), np.float64)
    lo = np.fmin(ts, mts)
    hi = np.fmax(ts, mts)
    lo = np.where(np.isnan(lo), ts, lo)
    hi = np.where(np.isnan(hi), ts, hi)
    return (hi >= start) & (lo <= end)


# ---------------------------------------------------------------------------
# selection execution: fused mask apply + structure remap
# ---------------------------------------------------------------------------

def _strip(ev: EventFrame) -> EventFrame:
    return ev.drop(*DERIVED_COLUMNS)


def _remap_safe(keep: np.ndarray, match: np.ndarray, parent: np.ndarray,
                is_call: np.ndarray) -> bool:
    """True when the selection provably preserves derived structure:

    * no kept Enter/Leave is unmatched (unbalanced traces always recompute),
    * every kept event's matching partner is kept (pairs intact),
    * every kept event's parent is kept (so, transitively, dropped events
      form whole subtrees and recomputed depth/parents equal the originals).
    """
    has_m = match >= 0
    if np.any(keep & is_call & ~has_m):
        return False
    km = keep & has_m
    if not np.all(keep[match[km]]):
        return False
    kp = keep & (parent >= 0)
    if not np.all(keep[parent[kp]]):
        return False
    return True


def _remap_messages(trace, keep: np.ndarray, new_index: np.ndarray
                    ) -> Optional[np.ndarray]:
    """Remap the cached send/recv matching, or None when FIFO re-matching on
    the sub-frame could pair differently (partner dropped, or unmatched
    message instants survive the selection)."""
    mm = trace._msg_match
    if mm is None:
        return None
    has = mm >= 0
    if not np.all(keep[mm[keep & has]]):
        return None  # a kept message's partner is dropped
    name = trace.events.cat(NAME)
    msgish = name.mask_eq(MPI_SEND) | name.mask_eq(MPI_RECV)
    if np.any(keep & msgish & ~has):
        return None  # surviving unmatched instants could re-pair
    old = mm[keep]
    return np.where(old >= 0, new_index[np.maximum(old, 0)], -1)


def apply_selection(trace, keep: np.ndarray):
    """Materialize ``trace`` restricted to ``keep`` rows.

    When the parent trace carries structure and the selection preserves it
    (see :func:`_remap_safe`), the matching/parent index columns are remapped
    through the old→new row map and inc/exc are recomputed with the same
    O(N) kernel the from-scratch path uses — bit-identical results without
    any lexsort.  Otherwise derived columns are dropped and recomputed
    lazily, exactly like the eager path.
    """
    keep = np.asarray(keep, bool)
    ev = trace.events
    cls = type(trace)
    structured = trace._structured and MATCH in ev and PARENT in ev
    if not structured:
        return cls(_strip(ev.mask(keep)), label=trace.label,
                   device=trace.device, definitions=trace.definitions)

    match = np.asarray(ev.column(MATCH), np.int64)
    parent = np.asarray(ev.column(PARENT), np.int64)
    et = ev.cat(ET)
    is_call = et.mask_eq(ENTER) | et.mask_eq(LEAVE)
    if not _remap_safe(keep, match, parent, is_call):
        return cls(_strip(ev.mask(keep)), label=trace.label,
                   device=trace.device, definitions=trace.definitions)

    idx = np.nonzero(keep)[0]
    new_index = np.full(len(keep), -1, np.int64)
    new_index[idx] = np.arange(len(idx))
    # drop every column we rebuild below before the take — no wasted gathers
    sub = ev.drop(CCT_NODE, MATCH, PARENT, INC, EXC, MATCH_TS).mask(keep)
    old_m, old_p = match[idx], parent[idx]
    sub[MATCH] = np.where(old_m >= 0, new_index[np.maximum(old_m, 0)], -1)
    sub[PARENT] = np.where(old_p >= 0, new_index[np.maximum(old_p, 0)], -1)
    new_match = np.asarray(sub.column(MATCH), np.int64)
    new_parent = np.asarray(sub.column(PARENT), np.int64)
    # exclusive metrics of boundary calls change when a subtree is dropped —
    # recompute with the canonical kernel (linear, no sort) for bit-identity
    inc, exc = structure.compute_inc_exc(sub, new_match, new_parent)
    sub[INC] = inc
    sub[EXC] = exc
    ts = np.asarray(sub[TS], np.float64)
    sub[MATCH_TS] = np.where(new_match >= 0, ts[np.maximum(new_match, 0)],
                             np.nan)
    out = cls(sub, label=trace.label, device=trace.device,
              definitions=trace.definitions)
    out._structured = True
    out._msg_match = _remap_messages(trace, keep, new_index)
    return out


def _has_overlap_leaf(f: Filter) -> bool:
    if isinstance(f, (_And, _Or)):
        return _has_overlap_leaf(f.a) or _has_overlap_leaf(f.b)
    if isinstance(f, _Not):
        return _has_overlap_leaf(f.a)
    return f.trim == "overlap"


def _split_windows(f: Filter):
    """(window steps, residual filter or None) for a conjunction tree."""
    if isinstance(f, _And):
        w1, r1 = _split_windows(f.a)
        w2, r2 = _split_windows(f.b)
        if r1 is None:
            residual = r2
        elif r2 is None:
            residual = r1
        else:
            residual = _And(r1, r2)
        return w1 + w2, residual
    if f.trim == "overlap":
        start, end = f.window()
        return [SliceTimeStep(start, end, "overlap")], None
    if _has_overlap_leaf(f):
        raise ValueError(
            "a time_window_filter(trim='overlap') cannot appear under '|' or "
            "'~'; compose it with '&' or chain .slice_time() on the query")
    return [], f


def _decompose_filter(f: Filter) -> List[Step]:
    """Split one filter into plan steps so overlap-trimmed time windows keep
    their call-interval semantics inside conjunctions.

    Windows are hoisted in front; everything else in the conjunction stays
    *one* FilterStep whose conjuncts evaluate against a single frame — like
    the seed's ``_And.mask`` — so ``a & b`` and ``b & a`` are identical even
    when a conjunct reads derived columns.  An overlap window under ``|`` or
    ``~`` has no well-defined row semantics and is rejected loudly rather
    than silently degrading to timestamp-within.
    """
    windows, residual = _split_windows(f)
    steps: List[Step] = list(windows)
    if residual is not None:
        steps.append(FilterStep(residual))
    return steps


def _fully_matched(trace) -> bool:
    """True when every Enter/Leave in the (structured) frame has a partner —
    the precondition for fusing a later overlap window without a barrier."""
    ev = trace.events
    if not trace._structured or MATCH not in ev:
        return False
    match = np.asarray(ev.column(MATCH), np.int64)
    et = ev.cat(ET)
    is_call = et.mask_eq(ENTER) | et.mask_eq(LEAVE)
    return not bool(np.any(is_call & (match < 0)))


def _and_masks(masks: List[np.ndarray]) -> np.ndarray:
    m = masks[0]
    for x in masks[1:]:
        m = m & x
    return m


# ---------------------------------------------------------------------------
# sources
# ---------------------------------------------------------------------------

class _TraceSource:
    def __init__(self, trace):
        self.trace = trace
        self.device = trace.device

    def load(self, procs=None, proc_bounds=None):
        return self.trace

    def describe(self) -> str:
        return f"trace({getattr(self.trace, 'label', None)!r}, " \
               f"{len(self.trace)} events)"


class _StreamSource:
    """Out-of-core source: a :class:`~repro_torch.core.streaming.StreamingTrace`
    handle.  Terminal ops with a registered streaming form execute chunk by
    chunk; ``collect()`` (and ops without one) materialize explicitly."""

    def __init__(self, handle):
        self.handle = handle
        self.device = handle.device

    def load(self, procs=None, proc_bounds=None):
        return self.handle.load_raw(procs=procs, proc_bounds=proc_bounds)

    def describe(self) -> str:
        h = self.handle
        return (f"stream({len(h.paths)} path(s), format={h.format!r}, "
                f"chunk_rows={h.chunk_rows})")


class _ScanSource:
    """Deferred sharded ingest: the paths are read (in a spawn pool when
    ``processes`` > 1) at collect time, after the plan's process
    restriction is known, so excluded shards are never parsed."""

    def __init__(self, paths: Sequence[str], format: str = "auto",
                 processes: Optional[int] = None, label: Optional[str] = None,
                 device="cuda"):
        self.paths = list(paths)
        self.format = format
        self.processes = processes
        self.label = label
        self.device = resolve_device(device)

    def load(self, procs=None, proc_bounds=None):
        from ..readers.parallel import read_parallel
        return read_parallel(self.paths, kind=self.format,
                             processes=self.processes, label=self.label,
                             procs=procs, proc_bounds=proc_bounds,
                             device=self.device)

    def describe(self) -> str:
        return f"scan({len(self.paths)} shard(s), format={self.format!r})"


# ---------------------------------------------------------------------------
# the query object
# ---------------------------------------------------------------------------

class TraceQuery:
    """An immutable logical plan over a trace source.

    Each step method returns a *new* query (plans share prefixes freely);
    nothing touches event data until :meth:`collect` or a terminal analysis
    op registered in :mod:`repro_torch.core.registry`.
    """

    def __init__(self, source, steps: Optional[Sequence[Step]] = None):
        self._source = source
        self._steps: Tuple[Step, ...] = tuple(steps or ())

    # -- construction ------------------------------------------------------
    @classmethod
    def from_trace(cls, trace) -> "TraceQuery":
        return cls(_TraceSource(trace))

    def _with(self, step: Step) -> "TraceQuery":
        return TraceQuery(self._source, self._steps + (step,))

    def filter(self, f: Filter) -> "TraceQuery":
        q = self
        for step in _decompose_filter(f):
            q = q._with(step)
        return q

    def slice_time(self, start: float, end: float,
                   trim: str = "overlap") -> "TraceQuery":
        return self._with(SliceTimeStep(start, end, trim))

    def restrict_processes(self, procs: Sequence[int]) -> "TraceQuery":
        return self._with(ProcessStep(procs))

    # the eager Trace method name, for symmetric chaining
    filter_processes = restrict_processes

    # -- planner introspection --------------------------------------------
    def explain(self) -> str:
        """Human-readable plan: fused segments and pushdown restrictions.

        Mirrors collect()'s barrier decisions; a barrier that depends on
        runtime state (unmatched calls in the frame) is marked conditional.
        """
        from .streaming import _steps_hints
        lines = [f"source: {self._source.describe()}"]
        hints = _steps_hints(self._steps)
        bounds, pset = hints.proc_bounds, hints.procs
        if isinstance(self._source, _ScanSource) and (bounds or
                                                      pset is not None):
            lines.append(f"pushdown: procs={sorted(pset) if pset else None} "
                         f"bounds={bounds}")
        seg = 0
        pending = False
        pair_preserving = True
        for step in self._steps:
            if step.reads_derived():
                if pending:
                    seg += 1
                    lines.append("-- materialize (derived-value barrier) --")
                    pending = False
                pair_preserving = False
            elif step.needs_structure():
                if pending and not pair_preserving:
                    seg += 1
                    lines.append("-- materialize (structure barrier) --")
                    pending = False
                    pair_preserving = True
                elif pending:
                    lines.append("   (fuses with pair-preserving selections; "
                                 "barrier only if the frame has unmatched "
                                 "calls)")
            elif not isinstance(step, ProcessStep):
                pair_preserving = False
            lines.append(f"segment {seg}: {step.describe()}")
            pending = True
        return "\n".join(lines)

    def __repr__(self) -> str:  # pragma: no cover
        return f"TraceQuery({len(self._steps)} step(s))"

    # -- execution ---------------------------------------------------------
    def collect(self):
        """Execute the plan and return the resulting Trace.

        A zero-step plan is the identity: it returns the source trace object
        itself (deliberately shared, so prerequisite materialization by
        terminal ops caches onto the source exactly like the eager methods).
        Any plan with steps returns a fresh Trace.

        Consecutive structure-independent selections are fused into a single
        mask.  A structure-dependent step (call-interval window) normally
        flushes pending masks first (one materialization) so its mask sees
        the structure of the selected frame — except when every pending mask
        is itself an overlap window on a fully matched frame: such
        selections keep enter/leave pairs, subtrees, and therefore per-row
        (ts, match_ts) intact, so the next window mask evaluated on the
        *base* frame is identical and the whole run of windows fuses into
        one materialization.  A predicate over derived *value* columns
        (time.inc/time.exc/_depth/...) always flushes first: those values
        change with the selection, and the eager chain sees the recomputed
        ones.
        """
        from .streaming import _steps_hints
        hints = _steps_hints(self._steps)
        cur = self._source.load(procs=hints.procs,
                                proc_bounds=hints.proc_bounds)
        if len(cur.events) == 0 and self._steps:
            # nothing to select from (e.g. every shard skipped); still hand
            # back a fresh Trace — selection must never alias its source
            return type(cur)(_strip(cur.events), label=cur.label,
                             device=cur.device, definitions=cur.definitions)
        masks: List[np.ndarray] = []
        pair_preserving = True  # every pending mask keeps call pairs intact
        for step in self._steps:
            if step.reads_derived():
                # derived values (inc/exc/depth/...) change with the
                # selection itself: flush unconditionally, recompute/remap,
                # then evaluate on the frame the eager chain would see
                if masks:
                    cur = apply_selection(cur, _and_masks(masks))
                    masks = []
                cur._ensure_structure()
                masks.append(step.mask(cur))
                pair_preserving = False
            elif step.needs_structure():
                if masks and pair_preserving:
                    # the fusion check needs matching columns; pending masks
                    # are pair-preserving, so structure computed here remaps
                    # through them if we do end up flushing
                    cur._ensure_structure()
                if masks and not (pair_preserving and _fully_matched(cur)):
                    cur = apply_selection(cur, _and_masks(masks))
                    masks = []
                    pair_preserving = True
                cur._ensure_structure()
                masks.append(step.mask(cur))
            else:
                masks.append(step.mask(cur))
                if not isinstance(step, ProcessStep):
                    # arbitrary predicates may split enter/leave pairs;
                    # process subsets keep whole timelines
                    pair_preserving = False
        if masks:
            cur = apply_selection(cur, _and_masks(masks))
        return cur

    # -- terminal analysis ops (registry-resolved) -------------------------
    def run(self, op_name: str, *args: Any, device=None, cache=None,
            **kwargs: Any) -> Any:
        """Execute a registered terminal op over this plan, its kernels on
        ``device`` (default: the source's).

        ``cache=`` (consumed here, never passed to the op) controls the
        plan-result cache (:mod:`repro_torch.core.plancache`): ``False``
        bypasses it, ``True`` opts an in-memory trace into content-hashed
        caching; the default caches streaming and scan sources only.  The
        device is part of the key, so a card result never answers a CPU
        call."""
        spec = registry.get_op(op_name)
        if spec is None:
            raise ValueError(f"unknown analysis op {op_name!r}; "
                             f"registered: {registry.list_ops()}")
        if spec.scope == "set":
            raise ValueError(
                f"{op_name!r} is a multi-trace comparison op; run it on a "
                f"TraceSet (repro_torch.core.diff.TraceSet) instead of a "
                f"single-trace query")
        dev = self._source.device if device is None else \
            resolve_device(device)
        kwargs = dict(kwargs, device=dev)
        from . import plancache
        key = plancache.plan_key(self._source, self._steps, spec, args,
                                 kwargs, cache)
        if key is not None:
            hit, value = plancache.lookup(key)
            if hit:
                return value
        if isinstance(self._source, _StreamSource):
            # out-of-core execution: fused masks run per chunk and the op's
            # aggregator buffers records for one kernel call at the end.
            # Ops without a streaming form raise StreamingUnsupported with
            # the escape hatches spelled out.
            from .streaming import execute_streaming
            result = execute_streaming(self._source.handle, self._steps,
                                       spec, args, kwargs, cache_flag=cache)
        else:
            trace = self.collect()
            if spec.needs_structure:
                trace._ensure_structure()
            if spec.needs_messages:
                trace._ensure_messages()
            result = registry.call_with_device(spec.fn, spec.takes_device,
                                               trace, *args, **kwargs)
        if key is not None:
            plancache.store(key, result)
        return result

    def __getattr__(self, name: str):
        return registry.terminal_op(name, self.run, "TraceQuery")


def scan(paths, format: str = "auto", processes: Optional[int] = None,
         label: Optional[str] = None, device="cuda") -> TraceQuery:
    """A query over on-disk shards that reads none of them yet: ``paths``
    is one path or a sequence of per-location shards, and the shards the
    plan's process restriction excludes are skipped before parsing.  The
    plan's ops run their kernels on ``device``."""
    if isinstance(paths, (str, bytes)) or hasattr(paths, "__fspath__"):
        paths = [paths]
    return TraceQuery(_ScanSource([os.fspath(p) for p in paths],
                                  format=format, processes=processes,
                                  label=label, device=device))
