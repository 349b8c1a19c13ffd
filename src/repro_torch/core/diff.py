"""TraceDiff: multi-trace comparison on the lazy query plan (paper §IV-D).

Mirrors :mod:`repro.core.diff`, the paper's "automated comparisons of two
or more datasets":

* :class:`TraceSet` — N traces opened through the reader registry
  ``Trace.open`` uses (in memory, or out of core with ``streaming=True``),
  held as one unit;
* :class:`SetQuery` — **one** lazy :class:`~repro_torch.core.query.
  TraceQuery` plan run across every member: each member is selected and
  its structure derived at most once per set, then reused by every
  terminal op; ``processes=N`` prepares the members in a spawn pool (the
  workers stay on the host);
* **set-scoped registry ops** registered with ``scope="set"``
  (``diff_flat_profile``, ``diff_time_profile``, ``scaling_analysis``,
  ``diff_load_imbalance``, ``regression_report``) terminate a set query as
  the single-trace ops terminate a trace query.

The comparison ops reduce each member with its own kernel-backed op
(``flat_profile`` → ``seg_sum``, ``time_profile`` → ``time_bin``,
``load_imbalance`` → ``pair_sum``), so a member's column in a comparison
is that member's own op result, bit for bit.  Every op takes
``device=``: None (the default) runs each member on its own device,
another value runs every member there.  Each member's flat profile is
computed once per (metric, device) and shared by the ops that align
profiles; a card profile never answers a CPU call (their f32 sums differ
in the last bits).

Example::

    ts = TraceSet([before, after], labels=["before", "after"])
    report = (ts.query()
                .filter(Filter("Name", "not-in", ["MPI_Wait"]))
                .regression_report())          # one plan, both traces
"""

from __future__ import annotations

import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import ops_summary, registry
from .accel import resolve_device
from .constants import ENTER, ET, EXC, NAME, TS
from .filters import Filter
from .frame import EventFrame
from .query import (ProcessStep, SliceTimeStep, TraceQuery, _decompose_filter,
                    _TraceSource)
from .streaming import StreamAgg, StreamingTrace

__all__ = ["TraceSet", "SetQuery", "run_labels", "align_flat_profiles",
           "diff_flat_profile", "diff_time_profile", "scaling_analysis",
           "diff_load_imbalance", "regression_report"]


# ---------------------------------------------------------------------------
# labels and name alignment
# ---------------------------------------------------------------------------

def run_labels(traces: Sequence) -> List[str]:
    """Display label per run: ``trace.label`` or ``run<i>``, deduplicated
    (a repeated label gets ``#<i>`` appended so derived column names stay
    unique)."""
    labels: List[str] = []
    seen: Dict[str, int] = {}
    for i, t in enumerate(traces):
        lbl = getattr(t, "label", None) or f"run{i}"
        if lbl in seen:
            lbl = f"{lbl}#{i}"
        seen[lbl] = i
        labels.append(lbl)
    return labels


def _device(t, device):
    """The device a member's op runs on: the caller's, else the member's."""
    return t.device if device is None else resolve_device(device)


def align_flat_profiles(traces: Sequence, metric: str = EXC,
                        top_n: Optional[int] = None, device=None
                        ) -> Tuple[List[str], List[str], np.ndarray,
                                   np.ndarray]:
    """Name-aligned flat profiles across runs.

    Computes each run's :func:`~repro_torch.core.ops_summary.flat_profile`
    (one ``seg_sum`` launch a member, on the member's device or
    ``device``) and joins them on function name — the alignment every
    comparison op builds on.  Functions present in only some runs get 0.0
    in the others; the ``present`` matrix records true membership so
    callers can tell "zero time" from "does not appear".

    Args:
        traces: sequence of Traces (or streaming handles).
        metric: ``time.exc`` (default) or ``time.inc``, ns summed over all
            calls and processes of a run.
        top_n: keep each run's top-N functions by the metric before taking
            the union (None = all functions).

    Returns:
        ``(labels, names, matrix, present)``: per-run labels, the union of
        function names ordered by total metric across runs (descending),
        a ``(n_runs, n_names)`` float matrix of per-run totals, and a same-
        shape bool matrix marking real membership.
    """
    _ensure_structured(traces)
    profs = [_flat_profile_cached(t, metric, _device(t, device))
             for t in traces]
    labels = run_labels(traces)
    weights: Dict[str, float] = {}
    for p in profs:
        names = p[NAME]
        vals = np.asarray(p[metric], np.float64)
        stop = top_n if top_n is not None else len(names)
        for nm, v in zip(names[:stop], vals[:stop]):
            weights[str(nm)] = weights.get(str(nm), 0.0) + float(v)
    cols = [nm for nm, _ in sorted(weights.items(), key=lambda kv: -kv[1])]
    idx = {nm: j for j, nm in enumerate(cols)}
    mat = np.zeros((len(traces), len(cols)))
    present = np.zeros((len(traces), len(cols)), dtype=bool)
    for i, p in enumerate(profs):
        for nm, v in zip(p[NAME], np.asarray(p[metric], np.float64)):
            j = idx.get(str(nm))
            if j is not None:
                mat[i, j] = float(v)
                present[i, j] = True
    return labels, cols, mat, present


def _ensure_structured(traces: Sequence) -> None:
    """Prerequisites for direct (non-query) calls; a no-op per member when
    the SetQuery engine already ensured them.  Streaming members have no
    whole-trace structure: their ops stitch it chunk by chunk."""
    for t in traces:
        if not isinstance(t, StreamingTrace):
            t._ensure_structure()


def _member_op(t, op_name: str, device, *args, **kwargs):
    """Run a single-trace op on one set member, on the member's device
    unless ``device`` says otherwise: an in-memory member calls the
    registered function directly (prerequisites already ensured); a
    streaming member runs the op's combinable form out of core."""
    if isinstance(t, StreamingTrace):
        return t.run(op_name, *args, device=device, **kwargs)
    spec = registry.get_op(op_name)
    return registry.call_with_device(spec.fn, spec.takes_device, t, *args,
                                     device=_device(t, device), **kwargs)


class _WholeStreamAgg(StreamAgg):
    """What ``scaling_analysis`` needs of a streamed member, in one pass:
    the total of a call metric over the whole selection — the per-row
    semantics of the eager total (each completed call contributes; an
    unmatched Enter contributes 0), *not* the flat-profile group semantics
    (where one unmatched Enter zeroes its whole function) — and the span
    and process count of the masked stream.  The reference reads those in
    a statistics pass and a second pass for the total.  Host float64 sums
    of integer-ns values, exact."""

    needs_calls = True
    supports_parallel = True

    def __init__(self, metric: str = EXC):
        if metric not in ("time.inc", EXC):
            from .streaming import StreamingUnsupported
            raise StreamingUnsupported(
                f"streaming scaling_analysis supports metrics "
                f"('time.inc', {EXC!r}), got {metric!r}; open the members "
                f"with streaming=False for custom metric columns")
        self.metric = metric
        self.total = 0.0
        self.n_events = 0
        self.ts_min, self.ts_max = np.inf, -np.inf

    def update(self, chunk) -> None:
        ev = chunk.events
        if len(ev):  # a seam block of the parallel merge has no events
            ts = np.asarray(ev[TS], np.float64)
            self.n_events += len(ev)
            self.ts_min = min(self.ts_min, float(ts.min()))
            self.ts_max = max(self.ts_max, float(ts.max()))
        calls = chunk.calls
        if calls is None or len(calls.name) == 0:
            return
        vals = calls.inc if self.metric == "time.inc" else calls.exc
        self.total += float(np.nan_to_num(vals).sum())

    def merge_from(self, other, code_map) -> None:
        self.total += other.total
        self.n_events += other.n_events
        self.ts_min = min(self.ts_min, other.ts_min)
        self.ts_max = max(self.ts_max, other.ts_max)

    def result(self, ctx) -> Tuple[int, float, float]:
        """(process count, duration ns, metric total)."""
        dur = (self.ts_max - self.ts_min) if self.n_events else 0.0
        return ctx.num_processes, dur, self.total

    def fold_form(self):
        """Its own ``fold="chunks"`` form: its host float64 totals are
        already bounded."""
        return self


def _stream_facts(t: StreamingTrace, metric: str) -> Tuple[int, float,
                                                           float]:
    from .streaming import execute_streaming
    spec = registry.OpSpec("_whole_stream", fn=None,
                           streaming=_WholeStreamAgg)
    return execute_streaming(t, t._steps, spec, (), {"metric": metric})


# flat profiles per trace object and (metric, device) — chained comparison
# ops over the same prepared members each align profiles, and would
# otherwise redo a full pass per member.  Weak keys: entries die with their
# traces.  The event count guards against in-place frame mutation.
_PROFILE_CACHE = weakref.WeakKeyDictionary()


def _flat_profile_cached(t, metric: str, device):
    key = (metric, device)
    if isinstance(t, StreamingTrace):
        # a handle's paths and plan steps are fixed; a live handle's pinned
        # snapshot moves at refresh(), so it is part of the key
        if getattr(t, "is_live", False):
            key += (tuple(sorted((p, s["rows"])
                                 for p, s in t._snapshots.items())),)
        entry = _PROFILE_CACHE.setdefault(t, {})
        if key not in entry:
            entry[key] = t.run("flat_profile", metrics=[metric],
                               device=device)
        return entry[key]
    n = len(t.events)
    entry = _PROFILE_CACHE.get(t)
    if entry is not None and entry.get("_n") == n and key in entry:
        return entry[key]
    prof = ops_summary.flat_profile(t, metrics=[metric], device=device)
    if entry is None or entry.get("_n") != n:
        entry = {"_n": n}
        _PROFILE_CACHE[t] = entry
    entry[key] = prof
    return prof


def _name_order_key(cols: Sequence[str]) -> np.ndarray:
    """Deterministic integer tie-break key for a list of unique names."""
    _, codes = np.unique(np.asarray(cols, dtype=object).astype(str),
                         return_inverse=True)
    return codes


def _require_runs(traces: Sequence, n: int, op: str) -> None:
    if len(traces) < n:
        raise ValueError(f"{op} needs at least {n} traces, got {len(traces)}")


def _resolve_run(i: int, n: int) -> int:
    """Normalize a (possibly negative) run index; loud on out-of-range —
    silent wrapping would quietly compare a run against itself."""
    j = n + i if i < 0 else i
    if not 0 <= j < n:
        raise IndexError(f"run index {i} out of range for {n} traces")
    return j


# ---------------------------------------------------------------------------
# set-scoped comparison ops (registered like every single-trace op)
# ---------------------------------------------------------------------------

@registry.register_op("diff_flat_profile", needs_structure=True, scope="set")
def diff_flat_profile(traces: Sequence, metric: str = EXC,
                      mode: str = "absolute", baseline: int = 0,
                      top_n: Optional[int] = None,
                      device=None) -> EventFrame:
    """Per-function deltas between runs' flat profiles (§IV-D).

    Profiles are name-aligned across all runs (functions missing from a run
    count as 0), then every non-baseline run is compared against the
    baseline run.  ``diff_flat_profile([a, b])`` is antisymmetric in
    absolute/normalized mode: swapping the runs negates every delta.

    Args:
        traces: 2+ traces; ``baseline`` is an index into this sequence
            (negative indices allowed).
        metric: ``time.exc`` (default, ns of self time) or ``time.inc``.
        mode: ``"absolute"`` — delta in metric units (ns);
            ``"relative"`` — delta / baseline value (+inf where a function
            is new in a run, 0 where absent from both);
            ``"normalized"`` — each run's profile is first scaled to
            fractions of its own total (delta is a fraction).
        top_n: restrict alignment to each run's top-N functions.
        device: where the members' profiles run (None: each member's own).

    Returns:
        EventFrame with ``Name``, one ``<metric>|<label>`` column per run
        (post-normalization values for ``mode="normalized"``), and one
        ``delta|<label>`` column per non-baseline run, sorted by the largest
        absolute delta (ties broken by name).
    """
    _require_runs(traces, 2, "diff_flat_profile")
    if mode not in ("absolute", "relative", "normalized"):
        raise ValueError(f'mode must be "absolute", "relative" or '
                         f'"normalized", got {mode!r}')
    labels, cols, mat, _present = align_flat_profiles(
        traces, metric=metric, top_n=top_n, device=device)
    base_i = _resolve_run(baseline, len(traces))
    vals = mat
    if mode == "normalized":
        totals = mat.sum(axis=1, keepdims=True)
        vals = mat / np.maximum(totals, 1e-30)
    base = vals[base_i]
    deltas = []
    for i in range(len(traces)):
        if i == base_i:
            continue
        d = vals[i] - base
        if mode == "relative":
            with np.errstate(divide="ignore", invalid="ignore"):
                d = np.where(base > 0, d / np.maximum(base, 1e-30),
                             np.where(vals[i] > 0, np.inf, 0.0))
        deltas.append((labels[i], d))
    key = np.max(np.abs(np.asarray([d for _, d in deltas])), axis=0)
    finite = np.where(np.isfinite(key), key, np.nanmax(key[np.isfinite(key)],
                                                       initial=0.0) + 1.0)
    order = np.lexsort((_name_order_key(cols), -finite))
    out = EventFrame({NAME: np.asarray(cols, dtype=object)[order]})
    for i, lbl in enumerate(labels):
        out[f"{metric}|{lbl}"] = vals[i][order]
    for lbl, d in deltas:
        out[f"delta|{lbl}"] = d[order]
    return out


@registry.register_op("diff_time_profile", needs_structure=True, scope="set")
def diff_time_profile(traces: Sequence, num_bins: int = 32, metric: str = EXC,
                      baseline: int = 0, target: int = -1,
                      normalized: bool = False, device=None) -> EventFrame:
    """Binned time-profile delta between two runs (§IV-B applied to §IV-D).

    Each run's :func:`~repro_torch.core.ops_summary.time_profile` (one
    ``time_bin`` launch) spreads every call's metric over its [enter,
    leave) span and bins it.  Runs of different duration are *resampled*
    onto a common axis: each run's own [t_min, t_max] is divided into the
    same ``num_bins`` bins, so bin *i* means "the i-th fraction of that
    run" and the delta compares matching program phases.

    Args:
        traces: 2+ traces; ``baseline``/``target`` index into the sequence
            (defaults: first vs last).
        num_bins: bins per run.
        metric: ``time.exc`` (ns, default) or ``time.inc``.
        normalized: normalize each bin to fractions of that bin's total
            before differencing (compares shape, not magnitude).
        device: where the members' profiles run (None: each member's own).

    Returns:
        EventFrame with ``bin`` (index) and ``bin_frac`` (bin center as a
        fraction of run duration), plus one column per function present in
        either run holding ``target − baseline`` per bin, columns ordered
        by total absolute delta (descending).
    """
    _require_runs(traces, 2, "diff_time_profile")
    _ensure_structured(traces)
    n = len(traces)
    base_i, tgt_i = _resolve_run(baseline, n), _resolve_run(target, n)
    profs = {}
    for i in (base_i, tgt_i):
        p = _member_op(traces[i], "time_profile", device, num_bins=num_bins,
                       metric=metric, normalized=normalized)
        funcs = [c for c in p.columns if c not in ("bin_start", "bin_end")]
        profs[i] = {f: np.asarray(p[f], np.float64) for f in funcs}
    union = sorted(set(profs[base_i]) | set(profs[tgt_i]))
    zeros = np.zeros(num_bins)
    deltas = {f: profs[tgt_i].get(f, zeros) - profs[base_i].get(f, zeros)
              for f in union}
    order = sorted(union, key=lambda f: (-float(np.abs(deltas[f]).sum()), f))
    out = EventFrame({
        "bin": np.arange(num_bins, dtype=np.int64),
        "bin_frac": (np.arange(num_bins) + 0.5) / num_bins,
    })
    for f in order:
        out[f] = deltas[f]
    return out


@registry.register_op("scaling_analysis", needs_structure=True, scope="set")
def scaling_analysis(traces: Sequence, metric: str = EXC,
                     mode: str = "strong", top_n: Optional[int] = 8,
                     device=None) -> EventFrame:
    """Scaling series over a set of runs at different process counts (§IV-D,
    Fig. 12 — the paper's Tortuga scaling study).

    Runs are ordered by process count.  Wall-clock time (last − first event
    timestamp, ns) gives speedup/efficiency; the aligned per-function totals
    show *which* functions stop scaling.

    Args:
        traces: 2+ runs of the same application at different ``nprocs``.
        metric: per-function aggregate — ``time.exc`` (ns, default) or
            ``time.inc``.
        mode: ``"strong"`` — fixed total problem: efficiency =
            (T_base / T_p) / (p / p_base); ``"weak"`` — problem grows with
            p: efficiency = T_base / T_p.
        top_n: per-function columns for the top-N functions by total metric
            across runs (None = all).
        device: where the members' profiles run (None: each member's own).

    Returns:
        EventFrame sorted by process count with ``Run``, ``num_processes``,
        ``duration`` (wall ns), ``speedup``, ``efficiency``,
        ``<metric>.total`` (sum over all functions and processes, ns), and
        one ``<metric>`` column per top function.
    """
    _require_runs(traces, 2, "scaling_analysis")
    if mode not in ("strong", "weak"):
        raise ValueError(f'mode must be "strong" or "weak", got {mode!r}')
    # a streamed member's process count, span and total come from one pass
    # (the eager per-row nan_to_num sum exactly, unbalanced traces too)
    facts = {i: _stream_facts(t, metric) for i, t in enumerate(traces)
             if isinstance(t, StreamingTrace)}
    order = sorted(range(len(traces)), key=lambda i: (
        facts[i][0] if i in facts else traces[i].num_processes))
    runs = [traces[i] for i in order]
    labels, cols, mat, _ = align_flat_profiles(runs, metric=metric,
                                               top_n=top_n, device=device)
    nprocs = np.empty(len(runs))
    dur = np.empty(len(runs))
    tot = np.empty(len(runs))
    for i, (j, t) in enumerate(zip(order, runs)):
        if j in facts:
            nprocs[i], dur[i], tot[i] = facts[j]
            continue
        nprocs[i] = t.num_processes
        ev = t.events
        ts = np.asarray(ev[TS], np.float64)
        dur[i] = float(ts.max() - ts.min()) if len(ts) else 0.0
        # total over ALL functions (the aligned matrix is top_n-truncated)
        ent = ev.cat(ET).mask_eq(ENTER)
        tot[i] = float(np.nan_to_num(
            np.asarray(ev.column(metric), np.float64)[ent]).sum())
    speedup = np.where(dur > 0, dur[0] / np.maximum(dur, 1e-30), 0.0)
    ideal = nprocs / max(nprocs[0], 1.0)
    eff = speedup / ideal if mode == "strong" else speedup
    out = EventFrame({
        "Run": np.asarray(labels, dtype=object),
        "num_processes": nprocs.astype(np.int64),
        "duration": dur,
        "speedup": speedup,
        "efficiency": eff,
        f"{metric}.total": tot,
    })
    for j, c in enumerate(cols):
        out[c] = mat[:, j]
    return out


@registry.register_op("diff_load_imbalance", needs_structure=True,
                      scope="set")
def diff_load_imbalance(traces: Sequence, metric: str = EXC, baseline: int = 0,
                        target: int = -1, num_processes: int = 5,
                        device=None) -> EventFrame:
    """Per-function load-imbalance delta between two runs (§IV-D).

    Imbalance per function is max-over-processes / mean-over-processes of
    the metric (1.0 = perfectly balanced), from each run's
    :func:`~repro_torch.core.ops_summary.load_imbalance` (one ``pair_sum``
    launch); the delta shows which functions got *more* skewed.

    Args:
        traces: 2+ traces; ``baseline``/``target`` index into the sequence
            (defaults: first vs last).
        metric: ``time.exc`` (default) or ``time.inc``.
        num_processes: forwarded to the per-run op (size of its top-process
            list; does not affect the ratio).
        device: where the members' ops run (None: each member's own).

    Returns:
        EventFrame with ``Name``, ``imbalance|<label>`` for both runs (0
        where the function is absent), and ``delta`` (target − baseline),
        sorted by delta descending (ties broken by name).
    """
    _require_runs(traces, 2, "diff_load_imbalance")
    _ensure_structured(traces)
    n = len(traces)
    base_i, tgt_i = _resolve_run(baseline, n), _resolve_run(target, n)
    labels = run_labels(traces)
    col = f"{metric}.imbalance"
    imb: Dict[int, Dict[str, float]] = {}
    for i in (base_i, tgt_i):
        li = _member_op(traces[i], "load_imbalance", device, metric=metric,
                        num_processes=num_processes)
        imb[i] = {str(nm): float(v)
                  for nm, v in zip(li[NAME], np.asarray(li[col], np.float64))}
    union = sorted(set(imb[base_i]) | set(imb[tgt_i]))
    b = np.asarray([imb[base_i].get(f, 0.0) for f in union])
    t = np.asarray([imb[tgt_i].get(f, 0.0) for f in union])
    d = t - b
    order = np.lexsort((_name_order_key(union), -d))
    return EventFrame({
        NAME: np.asarray(union, dtype=object)[order],
        f"imbalance|{labels[base_i]}": b[order],
        f"imbalance|{labels[tgt_i]}": t[order],
        "delta": d[order],
    })


@registry.register_op("regression_report", needs_structure=True, scope="set")
def regression_report(traces: Sequence, metric: str = EXC, baseline: int = 0,
                      target: int = -1, threshold: float = 0.05,
                      top_n: Optional[int] = None,
                      device=None) -> EventFrame:
    """Ranked per-function regression report between two runs (§IV-D) — the
    automated "what got slower?" pass GUI tools cannot script.

    Functions are aligned by name across the baseline and target runs and
    ranked by delta of the metric, regressions first.  Functions appearing
    in only one run are flagged rather than silently zero-filled.

    Args:
        traces: 2+ traces; ``baseline``/``target`` index into the sequence
            (defaults: first vs last, i.e. before vs after).
        metric: ``time.exc`` (ns of self time, default) or ``time.inc``.
        threshold: relative-change cutoff separating ``regressed`` /
            ``improved`` from ``stable`` (0.05 = 5%).
        top_n: truncate the report to the N largest deltas (None = all).
        device: where the members' profiles run (None: each member's own).

    Returns:
        EventFrame sorted by delta descending (worst regression first, ties
        broken by name) with ``Name``, ``<metric>|<label>`` for both runs,
        ``delta`` (target − baseline, ns), ``delta_rel`` (delta / baseline;
        +inf for new functions), and ``status`` ∈ {``regressed``,
        ``improved``, ``stable``, ``new``, ``vanished``}.
    """
    _require_runs(traces, 2, "regression_report")
    n = len(traces)
    base_i, tgt_i = _resolve_run(baseline, n), _resolve_run(target, n)
    labels, cols, mat, present = align_flat_profiles(traces, metric=metric,
                                                     device=device)
    base, tgt = mat[base_i], mat[tgt_i]
    in_base, in_tgt = present[base_i], present[tgt_i]
    delta = tgt - base
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.where(base > 0, delta / np.maximum(base, 1e-30),
                       np.where(tgt > 0, np.inf, 0.0))
    status = np.where(~in_base & in_tgt, "new",
                      np.where(in_base & ~in_tgt, "vanished",
                               np.where(rel > threshold, "regressed",
                                        np.where(rel < -threshold, "improved",
                                                 "stable")))).astype(object)
    keep = in_base | in_tgt  # drop rows contributed only by other runs
    sel = np.nonzero(keep)[0]
    order = sel[np.lexsort((_name_order_key(cols)[sel], -delta[sel]))]
    if top_n is not None:
        by_mag = np.argsort(-np.abs(delta[order]), kind="stable")[:top_n]
        order = order[np.sort(by_mag)]
    return EventFrame({
        NAME: np.asarray(cols, dtype=object)[order],
        f"{metric}|{labels[base_i]}": base[order],
        f"{metric}|{labels[tgt_i]}": tgt[order],
        "delta": delta[order],
        "delta_rel": rel[order],
        "status": status[order],
    })


# ---------------------------------------------------------------------------
# process-parallel member preparation
# ---------------------------------------------------------------------------

def _prepare_member(args) -> tuple:
    """Pool worker: execute one member's plan and materialize its
    prerequisites, on the host.  The member is rebuilt on the CPU (a
    worker never initializes CUDA); the parent gives the prepared member
    back its device.  Returns the materialized pieces and whether CUDA was
    initialized in the worker."""
    import torch

    from .trace import Trace
    (events, structured, msg_match, definitions, label, steps,
     needs_structure, needs_messages) = args
    t = Trace(events, label=label, device="cpu", definitions=definitions)
    t._structured = structured
    t._msg_match = msg_match
    out = TraceQuery(_TraceSource(t), steps).collect()
    if needs_structure:
        out._ensure_structure()
    if needs_messages:
        out._ensure_messages()
    return (out.events, out._structured, out._msg_match, out.label,
            out.definitions, bool(torch.cuda.is_initialized()))


class SetQuery:
    """One immutable lazy plan over every member of a :class:`TraceSet`.

    Builder methods mirror :class:`~repro_torch.core.query.TraceQuery` and
    return a new query sharing the step tuple; nothing executes until a
    terminal op.  The first terminal op materializes each member once
    (selection applied, prerequisites ensured) and caches the result on
    this query, so chaining several comparison ops over the same plan pays
    ingest, mask application and event matching once per member.
    """

    def __init__(self, traces: Sequence, steps: Sequence = ()):
        self._traces = list(traces)
        self._steps = tuple(steps)
        self._collected: Optional[List] = None
        #: ``torch.cuda.is_initialized()`` of each member prepared in the
        #: last pooled preparation, in member order (never True)
        self.units_cuda: List[bool] = []

    # -- construction ------------------------------------------------------
    def _with(self, step) -> "SetQuery":
        return SetQuery(self._traces, self._steps + (step,))

    def filter(self, f: Filter) -> "SetQuery":
        q = self
        for step in _decompose_filter(f):
            q = q._with(step)
        return q

    def slice_time(self, start: float, end: float,
                   trim: str = "overlap") -> "SetQuery":
        return self._with(SliceTimeStep(start, end, trim))

    def restrict_processes(self, procs: Sequence[int]) -> "SetQuery":
        return self._with(ProcessStep(procs))

    filter_processes = restrict_processes

    def explain(self) -> str:
        """The shared plan, as TraceQuery.explain shows it for the first
        member's source."""
        lines = [f"set of {len(self._traces)} trace(s); shared plan:"]
        first = self._traces[0]
        if isinstance(first, StreamingTrace):
            proto = TraceQuery(first.query()._source, self._steps)
        else:
            proto = TraceQuery(_TraceSource(first), self._steps)
        lines.extend("  " + ln for ln in proto.explain().splitlines())
        return "\n".join(lines)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"SetQuery({len(self._traces)} trace(s), "
                f"{len(self._steps)} step(s))")

    # -- execution ---------------------------------------------------------
    def _pool_prepare(self, traces: Sequence, steps, needs_structure: bool,
                      needs_messages: bool, processes: int) -> List:
        """Run collect + prerequisite materialization in a spawn pool and
        reassemble the prepared Traces in the parent, each on its member's
        device (a spawn-unsafe ``__main__`` runs them serially, through
        :func:`~repro_torch.parallel_util.map_maybe_parallel`)."""
        from ..parallel_util import map_maybe_parallel
        from .trace import Trace
        args = [(t.events, t._structured, t._msg_match, t.definitions,
                 t.label, tuple(steps), needs_structure, needs_messages)
                for t in traces]
        parts, _pooled = map_maybe_parallel(_prepare_member, args, processes)
        out = []
        for src, (ev, structured, mm, label, defs, _cuda) in zip(traces,
                                                                  parts):
            t = Trace(ev, label=label, device=src.device, definitions=defs)
            t._structured = structured
            t._msg_match = mm
            out.append(t)
        self.units_cuda = [p[5] for p in parts]
        return out

    def _prepare(self, needs_structure: bool, needs_messages: bool,
                 processes: Optional[int] = None) -> List:
        """Collect every member's plan and ensure prerequisites, caching the
        materialized traces on this query (shared-plan execution).

        Streaming members are never materialized: the shared plan's steps
        are bound onto the handle (``with_steps``) and each terminal op
        executes them out of core, chunk by chunk."""
        use_pool = bool(processes and processes > 1)
        if self._collected is None and any(
                isinstance(t, StreamingTrace) for t in self._traces):
            # a zero-step plan binds nothing: the member itself, as a
            # zero-step collect() is its source, so the profile cache
            # answers every query over the same members
            self._collected = [
                (t.with_steps(tuple(t._steps) + self._steps)
                 if self._steps else t)
                if isinstance(t, StreamingTrace)
                else TraceQuery(_TraceSource(t), self._steps).collect()
                for t in self._traces]
        if self._collected is None:
            if use_pool and len(self._traces) > 1:
                self._collected = self._pool_prepare(
                    self._traces, self._steps, needs_structure,
                    needs_messages, processes)
            else:
                self._collected = [
                    TraceQuery(_TraceSource(t), self._steps).collect()
                    for t in self._traces]
        elif use_pool:
            # members were cached by an earlier terminal, but this op's
            # prerequisites may still be unmaterialized — honour the pool
            # request for that (possibly heavy) work too
            idx = [i for i, t in enumerate(self._collected)
                   if not isinstance(t, StreamingTrace)
                   and ((needs_structure and not t._structured)
                        or (needs_messages and t._msg_match is None))]
            if len(idx) > 1:
                prepared = self._pool_prepare(
                    [self._collected[i] for i in idx], (), needs_structure,
                    needs_messages, processes)
                for i, t in zip(idx, prepared):
                    self._collected[i] = t
        for t in self._collected:
            if isinstance(t, StreamingTrace):
                continue  # structure stitches per chunk inside each op
            if needs_structure:
                t._ensure_structure()
            if needs_messages:
                t._ensure_messages()
        return self._collected

    def collect(self, processes: Optional[int] = None) -> List:
        """Execute the shared plan; returns the list of selected Traces."""
        return list(self._prepare(False, False, processes))

    def run(self, op_name: str, *args: Any, processes: Optional[int] = None,
            device=None, **kwargs: Any) -> Any:
        """Run a registered op across the set, on ``device`` (None: each
        member's own).

        A ``scope="set"`` op receives the whole list of prepared traces and
        returns its comparison result; a ``scope="trace"`` op is mapped over
        the members and returns a list of per-trace results (in set order).
        ``processes`` > 1 prepares members in a spawn pool.
        """
        spec = registry.get_op(op_name)
        if spec is None:
            raise ValueError(f"unknown analysis op {op_name!r}; "
                             f"registered: {registry.list_ops()}")
        dev = None if device is None else resolve_device(device)
        traces = self._prepare(spec.needs_structure, spec.needs_messages,
                               processes)
        if spec.scope == "set":
            return registry.call_with_device(spec.fn, spec.takes_device,
                                             traces, *args, device=dev,
                                             **kwargs)
        return [_member_op(t, op_name, dev, *args, **kwargs) for t in traces]

    def __getattr__(self, name: str):
        return registry.terminal_op(name, self.run, "SetQuery")


def _relabel(t, label: str):
    """Shallow clone of a trace under a new label, sharing the events frame
    and every derivation cache with the original (a streaming or live
    handle shares its paths and pinned snapshots)."""
    if isinstance(t, StreamingTrace):
        clone = t.with_steps(t._steps)
        clone.label = label
        return clone
    clone = type(t)(t.events, label=label, device=t.device,
                    definitions=t.definitions)
    clone._structured = t._structured
    clone._msg_match = t._msg_match
    clone._cct = t._cct
    return clone


class TraceSet:
    """N traces analyzed as one unit — the entry point for cross-run diffs.

    Construct from traces (``TraceSet([a, b, c])``, in memory, streaming or
    live handles) or straight from disk with :meth:`open`.  Every
    registered analysis op is a method: set-scoped comparison ops
    (``diff_flat_profile``, ``regression_report``, ...) compare the
    members; single-trace ops map over them.  Start a shared lazy plan
    with :meth:`query` to select data once for several comparison ops.
    """

    def __init__(self, traces: Sequence,
                 labels: Optional[Sequence[str]] = None):
        self._traces = list(traces)
        if not self._traces:
            raise ValueError("TraceSet needs at least one trace")
        if labels is not None:
            if len(labels) != len(self._traces):
                raise ValueError(f"{len(labels)} labels for "
                                 f"{len(self._traces)} traces")
            # relabel via shallow clones — never mutate the caller's traces
            # (two sets over the same trace must not clobber each other's
            # labels); clones share the frame and derivation caches
            self._traces = [_relabel(t, lbl)
                            for t, lbl in zip(self._traces, labels)]

    @classmethod
    def open(cls, paths: Sequence, format: str = "auto",
             processes: Optional[int] = None,
             labels: Optional[Sequence[str]] = None, streaming: bool = False,
             chunk_rows: Optional[int] = None, device="cuda",
             fold: Optional[str] = None, **kw) -> "TraceSet":
        """Open N traces, each on ``device`` (any registered format, sniffed
        per member as ``Trace.open`` does).  Each item may itself be a list
        of per-rank shard paths.  ``processes`` > 1 opens members
        concurrently.

        ``streaming=True`` opens every member as an out-of-core
        :class:`~repro_torch.core.streaming.StreamingTrace`: comparison ops
        then stream each member chunk by chunk.  ``processes=N`` then turns
        on the parallel executor for every member, all members' work units
        fanning into **one** spawn pool, the shared scheduler's (worker
        start-up is paid once per set, not once per member).  ``fold=``
        (streaming only) is each member's (``Trace.open``'s): with
        ``"chunks"`` every comparison op folds its members' chunks into
        bounded state."""
        if streaming:
            from .streaming import DEFAULT_CHUNK_ROWS
            members = [StreamingTrace(p, format=format,
                                      chunk_rows=chunk_rows
                                      or DEFAULT_CHUNK_ROWS,
                                      processes=processes, device=device,
                                      fold=fold or "once", **kw)
                       for p in paths]
            if members and members[0].wants_parallel():
                from .scheduler import get_scheduler
                shared = get_scheduler().spawn_pool(processes)
                for m in members:
                    m._pool = shared
            return cls(members, labels=labels)
        if chunk_rows is not None:
            raise ValueError("chunk_rows only applies with streaming=True")
        if fold is not None:
            raise ValueError("fold only applies with streaming=True")
        from ..readers.parallel import open_many
        return cls(open_many(paths, kind=format, processes=processes,
                             device=device, **kw), labels=labels)

    # -- container protocol ------------------------------------------------
    @property
    def traces(self) -> List:
        return list(self._traces)

    @property
    def labels(self) -> List[str]:
        return run_labels(self._traces)

    def __len__(self) -> int:
        return len(self._traces)

    def __iter__(self):
        return iter(self._traces)

    def __getitem__(self, i):
        return self._traces[i]

    def __repr__(self) -> str:  # pragma: no cover
        return f"TraceSet({self.labels})"

    # -- analysis ----------------------------------------------------------
    def query(self) -> SetQuery:
        """Start one lazy plan executed across every member (see SetQuery)."""
        return SetQuery(self._traces)

    def run(self, op_name: str, *args: Any, **kwargs: Any) -> Any:
        return self.query().run(op_name, *args, **kwargs)

    def __getattr__(self, name: str):
        return registry.terminal_op(name, self.run, "TraceSet")
