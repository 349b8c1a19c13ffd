"""Summary ops: ``flat_profile``, ``time_profile`` and ``load_imbalance``
on the card, ``idle_time`` on the host, and ``multi_run_analysis`` over
the comparison machinery (paper §IV-B, §IV-D).

Mirrors the kernel paths of :mod:`repro.core.ops_summary`
(``_flat_profile_pallas``, ``_profile_from_records`` with
``_pallas_profile``, ``_load_imbalance_pallas``) and their assembly
helpers.  Each op gathers the completed-call records on the host, sorts
them into the canonical order (:func:`repro_torch.core.accel.canonical_order`)
and reduces them with one kernel launch on ``device`` — the card by
default, the kernels' plain versions with ``device="cpu"``.  Counts stay
exact host int64; metric sums agree with the reference's ``numpy``
backend to f32 rounding.

``idle_time`` has no kernel, in the reference or here: it sums in NumPy
on the host whatever the ``device`` (which is still checked).  Its
streaming form buffers the idle calls and sums them once, in the order
the in-memory op uses.  ``multi_run_analysis`` joins flat profiles
(:func:`repro_torch.core.diff.align_flat_profiles`): one ``seg_sum``
launch per run whose profile is not cached yet.

All functions take a Trace whose structure columns (matching, parent,
time.inc/time.exc) are already materialized; Trace methods guarantee that.

Each op also has a streaming aggregator (the reference's
``backend="pallas"`` branch of ``_FlatProfileAgg``, ``_TimeProfileAgg``
and ``_LoadImbalanceAgg``): it buffers the completed-call records chunk by
chunk and, at the end, makes the in-memory op's one kernel call on the
same records in the same canonical order, so both routes give the same
bits.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..kernels import time_bin as _time_bin
from . import accel
from .accel import resolve_device
from .constants import (DEFAULT_IDLE_NAMES, ENTER, ET, EXC, INC, MATCH, NAME,
                        PROC, TS)
from .frame import Categorical, EventFrame
from .registry import register_op, register_streaming
from .streaming import (RecordBuffer, StreamAgg, StreamingUnsupported,
                        check_metric, grow_to)


def _calls(trace):
    """(is_enter, matching, float ts, matched-call rows) of a trace."""
    ev = trace.events
    is_enter = ev.cat(ET).mask_eq(ENTER)
    match = np.asarray(ev.column(MATCH), np.int64)
    ts = np.asarray(ev[TS], np.float64)
    return is_enter, match, ts, np.nonzero(is_enter & (match >= 0))[0]


def _flat_assemble(names_alpha, counts, sums, metrics, per_process
                   ) -> EventFrame:
    """Counts (exact int64) and per-metric sums, both on the alphabetical
    name axis, become the output frame."""
    out = EventFrame()
    if per_process:
        f_alpha, p_alpha = np.nonzero(counts)
        out[NAME] = Categorical(f_alpha.astype(np.int32), names_alpha)
        out[PROC] = p_alpha.astype(np.int64)
        out["count"] = counts[f_alpha, p_alpha]
        for i, m in enumerate(metrics):
            out[m] = sums[i, f_alpha, p_alpha]
    else:
        present = np.nonzero(counts)[0]
        out[NAME] = Categorical(present.astype(np.int32), names_alpha)
        out["count"] = counts[present]
        for i, m in enumerate(metrics):
            out[m] = sums[i, present]
    order = np.argsort(-np.asarray(out[metrics[0]]), kind="stable")
    return out.take(order)


@register_op("flat_profile", needs_structure=True)
def flat_profile(trace, metrics: Sequence[str] = (EXC,),
                 groupby_column: str = NAME, per_process: bool = False,
                 device="cuda") -> EventFrame:
    """Total metric per function over the whole trace (§IV-B): canonical
    ordered completed-call records through the ``seg_sum`` kernel, or
    ``pair_sum`` when ``per_process``.

    Args:
        metrics: metric columns to sum (``time.exc`` and/or ``time.inc``).
        groupby_column: must be ``Name`` (the kernel path groups by name).
        per_process: one row per (function, process) pair.
        device: where the kernel runs (``"cuda"`` or ``"cpu"``).

    Returns:
        EventFrame with the group key column(s), one summed column per
        metric (ns), and ``count`` (number of calls), sorted by the first
        metric descending.
    """
    if groupby_column != NAME:
        raise ValueError(
            f"flat_profile groups by {NAME!r} only, got "
            f"groupby_column={groupby_column!r}")
    metrics = list(metrics)
    ev = trace.events
    is_enter, match, ts, msel = _calls(trace)
    codes = ev.codes(NAME)
    procs = np.asarray(ev[PROC], np.int64)
    names_alpha, _order, inv = accel.alpha_positions(ev.cat(NAME).categories)
    nf = len(names_alpha)
    nprocs = max(trace.num_processes, 1)

    ent = np.nonzero(is_enter)[0]
    acode_all = inv[codes[ent]]
    if per_process:
        counts = np.zeros((nf, nprocs), np.int64)
        np.add.at(counts, (acode_all, procs[ent]), 1)
    else:
        counts = np.bincount(acode_all, minlength=nf).astype(np.int64)

    # kernel records: matched calls only (unmatched enters contribute
    # exactly 0 to the reference sums; the NaN-poisoning they cause is
    # applied per metric below, mirroring nan_to_num-after-groupby)
    vals = np.stack([np.nan_to_num(
        np.asarray(ev.column(m), np.float64)[msel]) for m in metrics],
        axis=1)
    acode = inv[codes[msel]]
    pr = procs[msel]
    o = accel.canonical_order(ts[msel], ts[match[msel]], pr, acode,
                              vals[:, 0])
    if per_process:
        sums = np.stack([accel.pair_sum(acode[o], pr[o], vals[o, i],
                                        nf, nprocs, device=device)
                         for i in range(len(metrics))])
    else:
        sums = accel.seg_sum(acode[o], vals[o], nf, device=device).T
    for i, m in enumerate(metrics):
        bad = np.isnan(np.asarray(ev.column(m), np.float64)[ent])
        if bad.any():
            if per_process:
                sums[i][acode_all[bad], procs[ent][bad]] = 0.0
            else:
                sums[i][acode_all[bad]] = 0.0
    return _flat_assemble(names_alpha, counts, sums, metrics, per_process)


@register_op("time_profile", needs_structure=True)
def time_profile(trace, num_bins: int = 32, metric: str = EXC,
                 normalized: bool = False, device="cuda") -> EventFrame:
    """Flat profile over time (§IV-B): bins × functions.

    Each matched call contributes its metric, spread uniformly over its
    [enter, leave) span; the trace's [t_min, t_max] is cut into
    ``num_bins`` equal bins, accumulated by the ``time_bin`` kernel.

    Returns:
        EventFrame with ``bin_start``/``bin_end`` (ns) plus one column per
        function holding its per-bin metric (ns, or fractions when
        ``normalized``), columns ordered by total weight descending.
    """
    ev = trace.events
    ts = np.asarray(ev[TS], np.float64)
    if len(ev) == 0:
        return EventFrame({"bin_start": np.asarray([]),
                           "bin_end": np.asarray([])})
    t0, t1 = float(ts.min()), float(ts.max())
    if t1 <= t0:
        t1 = t0 + 1.0
    edges = np.linspace(t0, t1, num_bins + 1)

    _is_enter, match, _ts, sel = _calls(trace)
    starts = ts[sel]
    ends = ts[match[sel]]
    w = np.nan_to_num(np.asarray(ev.column(metric), np.float64)[sel])
    names_alpha, _order, inv = accel.alpha_positions(ev.cat(NAME).categories)
    procs = np.asarray(ev[PROC], np.int64)[sel]
    return _profile_from_records(starts, ends, w, procs,
                                 inv[ev.codes(NAME)[sel]], names_alpha,
                                 edges, num_bins, normalized, device)


def _profile_from_records(starts, ends, w, procs, acodes, names_alpha,
                          edges, num_bins, normalized, device
                          ) -> EventFrame:
    """Record-level ``time_profile`` core: canonical-sort the call
    records, launch the kernel once, apply the zero-duration fixup and
    assemble columns in the alphabetical code space."""
    o = accel.canonical_order(starts, ends, procs, acodes, w)
    starts, ends, w, acodes = starts[o], ends[o], w[o], acodes[o]
    inc = ends - starts
    rate = np.where(inc > 0, w / np.maximum(inc, 1e-30), 0.0)
    prof = _kernel_profile(starts, ends, rate, acodes, edges,
                           len(names_alpha), device)
    zsel = inc <= 0
    if np.any(zsel & (w > 0)):
        b = np.clip(np.searchsorted(edges, starts[zsel], side="right") - 1,
                    0, num_bins - 1)
        np.add.at(prof, (b, acodes[zsel]), w[zsel])
    if normalized:
        denom = prof.sum(axis=1, keepdims=True)
        prof = prof / np.maximum(denom, 1e-30)
    out = EventFrame({"bin_start": edges[:-1], "bin_end": edges[1:]})
    keep = np.nonzero(prof.sum(axis=0) > 0)[0]
    order = keep[np.argsort(-prof[:, keep].sum(axis=0), kind="stable")]
    for f in order:
        out[str(names_alpha[f])] = prof[:, f]
    return out


def _kernel_profile(starts, ends, rate, name_codes, edges, nf,
                    device) -> np.ndarray:
    """The ``time_bin`` kernel over records in bin units → float64
    ``[bins, functions]``.  Mirrors ``_pallas_profile``: coordinates are
    normalized to bin units (f32 arithmetic loses ns-scale precision at
    bin boundaries otherwise) and a zero-width span returns zeros."""
    dev = accel.resolve_device(device)
    num_bins = len(edges) - 1
    t0, t1 = float(edges[0]), float(edges[-1])
    bw = (t1 - t0) / num_bins
    if not (bw > 0) or not np.isfinite(bw):
        # degenerate span: every overlap is zero — dividing by bw would
        # turn that into NaN where the reference returns zeros
        return np.zeros((num_bins, nf))

    def f32(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)

    out = _time_bin.time_bin(
        f32((starts - t0) / bw), f32((ends - t0) / bw),
        torch.from_numpy(np.ascontiguousarray(name_codes, np.int32)).to(dev),
        f32(rate * bw), n_funcs=nf, n_bins=num_bins, t0=0.0,
        t1=float(num_bins))
    return out.cpu().numpy().astype(np.float64).T


def _imbalance_assemble(tot, names_alpha, metric, num_processes,
                        top_functions, nprocs) -> EventFrame:
    """The per-(function, process) totals matrix becomes the ranked
    imbalance frame."""
    nf = tot.shape[0]
    active = tot.sum(axis=1) > 0
    mean = tot.sum(axis=1) / max(nprocs, 1)
    mx = tot.max(axis=1) if tot.size else np.zeros(nf)
    imb = np.where(mean > 0, mx / np.maximum(mean, 1e-30), 0.0)
    topk = np.argsort(-tot, axis=1)[:, :num_processes]
    sel = np.nonzero(active)[0]
    order = sel[np.argsort(-mean[sel], kind="stable")]
    if top_functions:
        order = order[:top_functions]
    return EventFrame({
        NAME: Categorical(order.astype(np.int32), names_alpha),
        f"{metric}.imbalance": imb[order],
        "Top processes": np.asarray([list(map(int, topk[i])) for i in order],
                                    dtype=object),
        f"{metric}.mean": mean[order],
        f"{metric}.max": mx[order],
    })


@register_op("load_imbalance", needs_structure=True)
def load_imbalance(trace, metric: str = EXC, num_processes: int = 5,
                   top_functions: Optional[int] = None,
                   device="cuda") -> EventFrame:
    """Per-function load imbalance across processes (§IV-D): canonical
    ordered completed-call records through the ``pair_sum`` kernel
    (function × rank totals), then max-over-processes / mean.

    Returns:
        EventFrame sorted by mean metric descending with ``Name``,
        ``<metric>.imbalance``, ``Top processes``, ``<metric>.mean`` and
        ``<metric>.max`` (ns).
    """
    ev = trace.events
    _is_enter, match, ts, sel = _calls(trace)
    vals = np.nan_to_num(np.asarray(ev.column(metric), np.float64)[sel])
    names_alpha, _order, inv = accel.alpha_positions(ev.cat(NAME).categories)
    acode = inv[ev.codes(NAME)[sel]]
    procs = np.asarray(ev[PROC], np.int64)[sel]
    nprocs = trace.num_processes
    o = accel.canonical_order(ts[sel], ts[match[sel]], procs, acode, vals)
    tot = accel.pair_sum(acode[o], procs[o], vals[o], len(names_alpha),
                         max(nprocs, 1), device=device)
    return _imbalance_assemble(tot, names_alpha, metric, num_processes,
                               top_functions, nprocs)


# ---------------------------------------------------------------------------
# streaming forms: buffer the records, one kernel call in result()
# ---------------------------------------------------------------------------

def call_metric(calls, metric: str) -> np.ndarray:
    """A completed-call block's ``metric`` column, NaN-safe."""
    return np.nan_to_num(calls.inc if metric == INC else calls.exc)


def _pad_to(arr: np.ndarray, shape) -> np.ndarray:
    """Zero-padded copy of ``arr`` with exactly ``shape`` (accumulators may
    be under-grown when late chunks discovered names but no calls, and
    over-grown by the power-of-two capacity)."""
    out = np.zeros(shape, dtype=arr.dtype)
    sub = arr[tuple(slice(0, min(a, s)) for a, s in zip(arr.shape, shape))]
    out[tuple(slice(0, n) for n in sub.shape)] = sub
    return out


def _scatter_names(dst: np.ndarray, src: np.ndarray, code_map: np.ndarray,
                   axis: int) -> np.ndarray:
    """Add ``src`` (a work unit's accumulator whose ``axis`` is indexed by
    the unit's local name codes) into ``dst`` with that axis remapped
    through ``code_map``.  ``src`` is padded to exactly ``len(code_map)``
    names (and ``dst``'s extents on the other axes); ``dst`` is grown to
    hold the remapped codes.  ``code_map`` entries are unique, so a
    fancy-indexed ``+=`` is exact."""
    k = len(code_map)
    if k == 0:
        return dst
    want = list(dst.shape)
    for ax in range(dst.ndim):
        if ax == axis:
            want[ax] = k
        else:
            want[ax] = max(want[ax], src.shape[ax] if ax < src.ndim else 0)
    src = _pad_to(src, tuple(want))
    grown = list(src.shape)
    grown[axis] = int(code_map.max()) + 1
    dst = grow_to(dst, tuple(grown))
    idx = [slice(0, n) for n in src.shape]
    idx[axis] = code_map
    dst[tuple(idx)] += src
    return dst


@register_streaming("flat_profile")
class _FlatProfileAgg(StreamAgg):
    """Streaming flat profile: call counts over every Enter row, accumulated
    per chunk (exact int64), and the completed-call records buffered for
    the in-memory op's one ``seg_sum`` (or ``pair_sum``) call.  A name with
    a call left open at the end gets a total of 0, as an unmatched enter's
    NaN gives it in memory.  A work unit's state merges into another's by
    remapping its name codes (:meth:`merge_from`)."""

    needs_calls = True
    supports_parallel = True

    def __init__(self, metrics: Sequence[str] = (EXC,),
                 groupby_column: str = NAME, per_process: bool = False,
                 device="cuda"):
        if groupby_column != NAME:
            raise StreamingUnsupported(
                f"streaming flat_profile groups by {NAME!r} only, got "
                f"groupby_column={groupby_column!r}")
        self.metrics = list(metrics)
        for m in self.metrics:
            check_metric(m, "flat_profile")
        self.per_process = per_process
        self.device = device
        self._recs = RecordBuffer(len(self.metrics))
        self._counts = np.zeros((0, 0) if per_process else (0,), np.int64)

    def update(self, chunk) -> None:
        ev = chunk.events
        is_enter = ev.cat(ET).mask_eq(ENTER)
        codes = chunk.gcodes[is_enter]
        nf = len(chunk.names)
        calls = chunk.calls
        self._recs.add(calls, np.stack(
            [call_metric(calls, m) for m in self.metrics], axis=1))
        if self.per_process:
            procs = np.asarray(ev[PROC], np.int64)[is_enter]
            np_ = int(procs.max()) + 1 if len(procs) else 0
            self._counts = grow_to(self._counts, (nf, np_))
            np.add.at(self._counts, (codes, procs), 1)
        else:
            self._counts = grow_to(self._counts, (nf,))
            np.add.at(self._counts, codes, 1)

    def merge_from(self, other, code_map) -> None:
        """Counts added at the merged codes (a unit's local codes map to
        distinct merged ones), records appended after this state's."""
        self._recs.merge(other._recs, code_map)
        c = other._counts
        rows = min(c.shape[0], len(code_map))
        if rows == 0:
            return
        dst = code_map[:rows]
        shape = (int(dst.max()) + 1,) + c.shape[1:]
        self._counts = grow_to(self._counts, shape)
        self._counts[(dst,) + tuple(slice(0, n) for n in c.shape[1:])] += \
            c[:rows]

    def result(self, ctx) -> EventFrame:
        nf = len(ctx.names)
        names_alpha, order, inv = accel.alpha_positions(ctx.names.names)
        acode, proc, start, end, vals = self._recs.gather(inv)
        o = accel.canonical_order(start, end, proc, acode, vals[:, 0])
        open_names, open_procs = ctx.open_calls
        if self.per_process:
            nprocs = max(ctx.num_processes, 1)
            counts = _pad_to(self._counts, (nf, nprocs))[order]
            sums = np.stack([accel.pair_sum(acode[o], proc[o], vals[o, i],
                                            nf, nprocs, device=self.device)
                             for i in range(len(self.metrics))])
            sums[:, inv[open_names], open_procs] = 0.0
        else:
            counts = _pad_to(self._counts, (nf,))[order]
            sums = accel.seg_sum(acode[o], vals[o], nf,
                                 device=self.device).T
            sums[:, inv[open_names]] = 0.0
        return _flat_assemble(names_alpha, counts, sums, self.metrics,
                              self.per_process)


@register_streaming("time_profile")
class _TimeProfileAgg(StreamAgg):
    """Streaming time profile: the stream's time span tracked per chunk
    (the bin edges of the in-memory op), the completed-call records
    buffered for its one ``time_bin`` call."""

    needs_calls = True
    supports_parallel = True

    def __init__(self, num_bins: int = 32, metric: str = EXC,
                 normalized: bool = False, device="cuda"):
        check_metric(metric, "time_profile")
        self.num_bins = num_bins
        self.metric = metric
        self.normalized = normalized
        self.device = device
        self._recs = RecordBuffer()
        self._t0, self._t1 = np.inf, -np.inf

    def update(self, chunk) -> None:
        ts = np.asarray(chunk.events[TS], np.float64)
        if len(ts):  # a seam block of the parallel merge has no events
            self._t0 = min(self._t0, float(ts.min()))
            self._t1 = max(self._t1, float(ts.max()))
        self._recs.add(chunk.calls, call_metric(chunk.calls, self.metric))

    def merge_from(self, other, code_map) -> None:
        self._t0 = min(self._t0, other._t0)
        self._t1 = max(self._t1, other._t1)
        self._recs.merge(other._recs, code_map)

    def result(self, ctx) -> EventFrame:
        if self._t0 > self._t1:
            return EventFrame({"bin_start": np.asarray([]),
                               "bin_end": np.asarray([])})
        t1 = self._t1 if self._t1 > self._t0 else self._t0 + 1.0
        edges = np.linspace(self._t0, t1, self.num_bins + 1)
        names_alpha, _order, inv = accel.alpha_positions(ctx.names.names)
        acode, proc, start, end, w = self._recs.gather(inv)
        return _profile_from_records(start, end, w[:, 0], proc, acode,
                                     names_alpha, edges, self.num_bins,
                                     self.normalized, self.device)


@register_streaming("load_imbalance")
class _LoadImbalanceAgg(StreamAgg):
    """Streaming load imbalance: the completed-call records buffered for
    the in-memory op's one ``pair_sum`` call (function × rank totals)."""

    needs_calls = True
    supports_parallel = True

    def __init__(self, metric: str = EXC, num_processes: int = 5,
                 top_functions: Optional[int] = None, device="cuda"):
        check_metric(metric, "load_imbalance")
        self.metric = metric
        self.num_processes = num_processes
        self.top_functions = top_functions
        self.device = device
        self._recs = RecordBuffer()

    def update(self, chunk) -> None:
        self._recs.add(chunk.calls, call_metric(chunk.calls, self.metric))

    def merge_from(self, other, code_map) -> None:
        self._recs.merge(other._recs, code_map)

    def result(self, ctx) -> EventFrame:
        names_alpha, _order, inv = accel.alpha_positions(ctx.names.names)
        acode, proc, start, end, vals = self._recs.gather(inv)
        vals = vals[:, 0]
        nprocs = ctx.num_processes
        o = accel.canonical_order(start, end, proc, acode, vals)
        tot = accel.pair_sum(acode[o], proc[o], vals[o], len(names_alpha),
                             max(nprocs, 1), device=self.device)
        return _imbalance_assemble(tot, names_alpha, self.metric,
                                   self.num_processes, self.top_functions,
                                   nprocs)


# ---------------------------------------------------------------------------
# idle time (host) and the multi-run table
# ---------------------------------------------------------------------------

def _idle_sum(proc, start, end, inc, nprocs: int,
              k: Optional[int]) -> EventFrame:
    """Idle ns per process, most idle first (stable).  Each process sums
    its calls in Enter order — start, then the outer of two calls that
    start together — which is the row order of a trace kept in (process,
    time) order, whatever order a route gathered the records in."""
    out = np.zeros(max(nprocs, 0))
    o = np.lexsort((inc, -end, start, proc))
    np.add.at(out, proc[o], np.nan_to_num(inc[o]))
    order = np.argsort(-out, kind="stable")
    res = EventFrame({PROC: order.astype(np.int32), "idle_time": out[order]})
    return res.head(k) if k else res


@register_op("idle_time", needs_structure=True)
def idle_time(trace, idle_functions: Sequence[str] = DEFAULT_IDLE_NAMES,
              k: Optional[int] = None, device="cuda") -> EventFrame:
    """Total idle (wait/recv) time per process (§IV-D), sorted descending.

    Sums the *inclusive* time (ns) of every completed call whose name is
    in ``idle_functions`` — inclusive, because the whole span of an
    MPI_Wait counts as idle regardless of what bookkeeping runs inside it.

    Args:
        idle_functions: names treated as idleness (default: MPI_Wait,
            MPI_Waitall, MPI_Recv, Idle, MPI_Barrier).
        k: keep only the k most-idle processes (None = all).
        device: the op's device (host NumPy either way).

    Returns:
        EventFrame with ``Process`` and ``idle_time`` (ns), most idle first.
    """
    resolve_device(device)
    ev = trace.events
    is_enter, match, ts, _sel = _calls(trace)
    sel = np.nonzero(is_enter & (match >= 0)
                     & ev.cat(NAME).mask_isin(idle_functions))[0]
    return _idle_sum(np.asarray(ev[PROC], np.int64)[sel], ts[sel],
                     ts[match[sel]],
                     np.asarray(ev.column(INC), np.float64)[sel],
                     trace.num_processes, k)


@register_streaming("idle_time")
class _IdleTimeAgg(StreamAgg):
    """Streaming idle time: the idle-named completed calls buffered, then
    summed once as the in-memory op sums them."""

    needs_calls = True
    supports_parallel = True

    def __init__(self, idle_functions: Sequence[str] = DEFAULT_IDLE_NAMES,
                 k: Optional[int] = None, device="cuda"):
        resolve_device(device)
        self.idle = [str(n) for n in idle_functions]
        self.k = k
        self._recs = RecordBuffer()

    def update(self, chunk) -> None:
        calls = chunk.calls
        codes = [c for c in map(chunk.names.code, self.idle) if c >= 0]
        if not codes or len(calls.name) == 0:
            return
        keep = np.isin(calls.name, np.asarray(codes, np.int64))
        if keep.any():
            self._recs.add(calls, calls.inc, keep)

    def merge_from(self, other, code_map) -> None:
        self._recs.merge(other._recs, code_map)

    def result(self, ctx) -> EventFrame:
        _code, proc, start, end, inc = self._recs.gather(
            np.arange(len(ctx.names)))
        return _idle_sum(proc, start, end, inc[:, 0], ctx.num_processes,
                         self.k)


def multi_run_analysis(traces: Sequence, metric: str = EXC, top_n: int = 16,
                       label_column: str = "Run", device=None) -> EventFrame:
    """Joined flat profiles across runs (§IV-D, Fig. 12).

    A thin wrapper over the comparison machinery
    (:func:`repro_torch.core.diff.align_flat_profiles`): one row per run,
    one column per function in the union of each run's top-``top_n``
    functions by ``metric`` (columns ordered by total weight across runs).
    Each run's profile is one ``seg_sum`` launch on its own device
    (``device=None``) or on ``device``, shared with the set ops through
    the per-(metric, device) profile cache.
    """
    from .diff import align_flat_profiles
    labels, cols, mat, _present = align_flat_profiles(
        traces, metric=metric, top_n=top_n, device=device)
    out = EventFrame({label_column: np.asarray(labels, dtype=object)})
    for j, c in enumerate(cols):
        out[c] = mat[:, j]
    return out
