"""Summary ops on the card: ``flat_profile``, ``time_profile`` and
``load_imbalance`` (paper §IV-B, §IV-D).

Mirrors the kernel paths of :mod:`repro.core.ops_summary`
(``_flat_profile_pallas``, ``_profile_from_records`` with
``_pallas_profile``, ``_load_imbalance_pallas``) and their assembly
helpers.  Each op gathers the completed-call records on the host, sorts
them into the canonical order (:func:`repro_torch.core.accel.canonical_order`)
and reduces them with one kernel launch on ``device`` — the card by
default, the kernels' plain versions with ``device="cpu"``.  Counts stay
exact host int64; metric sums agree with the reference's ``numpy``
backend to f32 rounding.

All functions take a Trace whose structure columns (matching, parent,
time.inc/time.exc) are already materialized; Trace methods guarantee that.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..kernels import time_bin as _time_bin
from . import accel
from .constants import ENTER, ET, EXC, MATCH, NAME, PROC, TS
from .frame import Categorical, EventFrame
from .registry import register_op


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
