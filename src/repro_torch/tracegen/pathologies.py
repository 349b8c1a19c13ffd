"""Ground-truth pathology injection for closed-loop detector tests.

Mirrors :mod:`repro.tracegen.pathologies`: the same edits from the same
seed, so both packages build the same events.  The generated traces live
on ``device`` (the card unless the caller asks for the CPU); the
injectors' own structure derivation runs on the host.

The diagnostics suite (:mod:`repro_torch.core.detectors`) is only
trustworthy if
each detector provably recovers a *known* problem and stays silent on a
problem-free trace.  This module supplies both halves:

* :func:`baseline` — a deliberately clean bulk-synchronous app: every rank
  does identical work, every message is sent well before its receiver
  needs it, both threads per rank share the load exactly, and iterations
  align 1:1 with the default efficiency windows.  Every registered
  detector returns zero findings on it at default thresholds.
* :func:`inject` — ``inject(events, pathology, magnitude, seed) ->
  (events, GroundTruth)``: surgically introduces one pathology into any
  app trace, returning machine-readable ground truth (which rank /
  function / time window the detector must name, at top-1).

Injections are pure timestamp/name edits in integer nanoseconds, so the
result is a valid trace by construction: per-(process, thread) Enter/Leave
nesting is preserved (timelines are stretched or shifted monotonically per
thread), and the edited frame round-trips through every on-disk format.
``magnitude`` scales the injected effect, so detector severity must grow
monotonically with it — the closed-loop property tests assert exactly
that.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np

from ..core.constants import (DERIVED_COLUMNS, ENTER, ET, EXC, MATCH,
                              MPI_SEND, NAME, PROC, THREAD, TS)
from ..core.detectors import _window_edges, is_comm_name
from ..core.frame import EventFrame
from ..core.trace import Trace
from .builder import TraceBuilder

__all__ = ["GroundTruth", "PATHOLOGIES", "baseline", "inject",
           "pathology_trace"]

#: pathology name -> the detector that must recover it at top-1
PATHOLOGIES = {
    "late_sender": "late_sender",
    "straggler": "stragglers",
    "serialization": "serialization",
    "imbalance": "imbalance_root_cause",
    "efficiency_drop": "pop_efficiency",
}


@dataclass(frozen=True)
class GroundTruth:
    """Machine-readable record of an injected pathology: what a correct
    detector must report.  ``process`` is -1 and ``function`` is ``""``
    where the pathology has no rank/function locality (then the time
    window carries the signal)."""

    pathology: str
    detector: str
    process: int
    function: str
    t_start: float
    t_end: float
    magnitude: float
    seed: int


# ---------------------------------------------------------------------------
# the clean baseline app
# ---------------------------------------------------------------------------

def baseline(nprocs: int = 4, iters: int = 16, seed: int = 0,
             with_threads: bool = True, device="cuda") -> Trace:
    """A pathology-free bulk-synchronous app every detector is silent on.

    Per iteration each rank computes (identical duration on every rank),
    sends to its ring successor, then receives from its predecessor —
    always after the matching send was posted, with a constant pick-up
    lag.  With ``with_threads`` a second thread carries exactly the same
    nesting-weighted busy time as the first.  Iteration length divides the
    trace span exactly, so the default 16 efficiency windows see identical
    activity and the POP detector's median gate stays silent.
    """
    rng = np.random.default_rng(seed)  # reserved: keeps signature uniform
    del rng
    b = TraceBuilder(with_threads=with_threads)
    compute_d, send_d, recv_d = 4000, 400, 600
    iter_d = compute_d + send_d + recv_d
    for p in range(nprocs):
        t = 0
        for _ in range(iters):
            b.enter(t, "iteration", p)
            if with_threads:
                # same window, same nesting-weighted busy time as thread 0
                b.enter(t, "overlap_shell", p, thread=1)
                b.call(t, iter_d, "overlap_compute", p, thread=1)
                b.leave(t + iter_d, "overlap_shell", p, thread=1)
            t = b.call(t, compute_d, "compute", p)
            t = b.send(t, send_d, p, (p + 1) % nprocs, 1024.0)
            t = b.recv(t, recv_d, p, (p - 1) % nprocs, 1024.0)
            b.leave(t, "iteration", p)
    return b.trace(label=f"baseline({nprocs}x{iters})", device=device)


# ---------------------------------------------------------------------------
# injection plumbing
# ---------------------------------------------------------------------------

def _fresh_events(source: Union[Trace, EventFrame]) -> EventFrame:
    """A mutable copy of the raw event columns (derived structure, which
    would be invalidated by timestamp edits, is dropped)."""
    ev = source.events if isinstance(source, Trace) else source
    return ev.drop(*DERIVED_COLUMNS).copy()


def _structured(ev: EventFrame) -> Trace:
    """A throwaway Trace over a copy of ``ev`` with enter/leave matching
    materialized — row indices align with ``ev`` (same order)."""
    tr = Trace.from_events(ev.copy(), device="cpu")
    tr._ensure_structure()
    return tr


def _resort(ev: EventFrame) -> EventFrame:
    """Restore the canonical (process, time) order trace files use."""
    return ev.sort_by([PROC, TS])


def _int_ts(ev: EventFrame) -> np.ndarray:
    return np.asarray(ev[TS], np.float64).astype(np.int64)


def _stretch(ts: np.ndarray, rows: np.ndarray, factor: float) -> None:
    """Stretch the selected rows' timeline about its own start by
    ``factor`` (monotone, exact integers — nesting survives)."""
    if len(rows) == 0:
        return
    t0 = ts[rows].min()
    ts[rows] = t0 + np.rint((ts[rows] - t0) * factor).astype(np.int64)


def _apply_ts(ev: EventFrame, ts: np.ndarray) -> EventFrame:
    ev[TS] = ts.astype(np.float64)
    return _resort(ev)


# ---------------------------------------------------------------------------
# injectors
# ---------------------------------------------------------------------------

def _inject_late_sender(ev, magnitude, rng, delay_frac: float = 0.02):
    """Delay one rank's MpiSend instants until after their matched
    receivers are already waiting — injected receiver wait scales with
    ``magnitude`` (≈ ``delay_frac * magnitude`` of the trace span per
    message source rank)."""
    tr = _structured(ev)
    tr._ensure_messages()
    mm = tr._msg_match
    name = ev.cat(NAME)
    ts = _int_ts(ev)
    sends = np.nonzero(name.mask_eq(MPI_SEND) & (mm >= 0))[0]
    if len(sends) == 0:
        raise ValueError("trace has no matched messages to make late")
    proc = np.asarray(ev[PROC], np.int64)
    culprit = int(rng.choice(np.unique(proc[sends])))
    mine = sends[proc[sends] == culprit]
    span = int(ts.max() - ts.min())
    lag = ts[mm[mine]] - ts[mine]
    # past every matched recv, plus a magnitude-scaled wait per message
    delay = int(lag.max()) + max(
        int(round(delay_frac * magnitude * span)) // max(len(mine), 1), 1)
    ts[mine] += delay
    out = _apply_ts(ev, ts)
    return out, GroundTruth(
        pathology="late_sender", detector="late_sender", process=culprit,
        function=MPI_SEND, t_start=float(ts[mine].min()),
        t_end=float(ts[mine].max()), magnitude=magnitude, seed=-1)


def _inject_straggler(ev, magnitude, rng):
    """Stretch one rank's entire timeline by ``magnitude`` — its work
    grows proportionally while everyone else stands still."""
    proc = np.asarray(ev[PROC], np.int64)
    culprit = int(rng.choice(np.unique(proc)))
    ts = _int_ts(ev)
    rows = np.nonzero(proc == culprit)[0]
    _stretch(ts, rows, magnitude)
    out = _apply_ts(ev, ts)
    return out, GroundTruth(
        pathology="straggler", detector="stragglers", process=culprit,
        function="", t_start=float(ts[rows].min()),
        t_end=float(ts[rows].max()), magnitude=magnitude, seed=-1)


def _inject_serialization(ev, magnitude, rng):
    """Pile one rank's overlapped work onto thread 0: thread 0's timeline
    is stretched by ``1 + magnitude`` while its other threads shrink by
    the same factor, so the dominant-thread share grows monotonically
    with ``magnitude``."""
    if THREAD not in ev:
        raise ValueError("serialization injection needs a threaded trace "
                         "(e.g. pathologies.baseline(with_threads=True))")
    proc = np.asarray(ev[PROC], np.int64)
    thread = np.asarray(ev[THREAD], np.int64)
    multi = np.unique(proc[thread > 0])
    if len(multi) == 0:
        raise ValueError("no rank has events on more than one thread")
    culprit = int(rng.choice(multi))
    factor = 1.0 + magnitude
    ts = _int_ts(ev)
    _stretch(ts, np.nonzero((proc == culprit) & (thread == 0))[0], factor)
    for t in np.unique(thread[(proc == culprit) & (thread > 0)]):
        _stretch(ts, np.nonzero((proc == culprit) & (thread == t))[0],
                 1.0 / factor)
    rows = np.nonzero(proc == culprit)[0]
    out = _apply_ts(ev, ts)
    return out, GroundTruth(
        pathology="serialization", detector="serialization", process=culprit,
        function="", t_start=float(ts[rows].min()),
        t_end=float(ts[rows].max()), magnitude=magnitude, seed=-1)


def _inject_imbalance(ev, magnitude, rng, function: Optional[str] = None):
    """Dilate one function's calls on one rank by ``magnitude``: each
    targeted call gets ``(magnitude - 1) x`` its duration appended, and
    everything after it on that rank shifts right — nesting intact, other
    ranks untouched."""
    tr = _structured(ev)
    sev = tr.events
    match = np.asarray(sev.column(MATCH), np.int64)
    ts = _int_ts(ev)
    proc = np.asarray(ev[PROC], np.int64)
    is_enter = sev.cat(ET).mask_eq(ENTER)
    names = ev.cat(NAME)
    culprit = int(rng.choice(np.unique(proc)))
    cand = np.nonzero(is_enter & (proc == culprit) & (match >= 0))[0]
    cand = cand[~np.asarray([is_comm_name(c)
                             for c in names.categories])[names.codes[cand]]]
    if len(cand) == 0:
        raise ValueError(f"rank {culprit} has no non-communication calls")
    if function is None:
        # the heaviest computation on the culprit rank, by exclusive time
        # (what the detector itself ranks by)
        exc = np.nan_to_num(np.asarray(sev.column(EXC), np.float64))
        per = {}
        for i, d in zip(names.codes[cand], exc[cand]):
            per[i] = per.get(i, 0) + int(d)
        function = str(names.categories[max(per, key=per.get)])
    hits = cand[np.asarray([str(names.categories[c]) == function
                            for c in names.codes[cand]])]
    if len(hits) == 0:
        raise ValueError(f"rank {culprit} never calls {function!r}")
    leaves = match[hits]
    extras = np.rint((magnitude - 1.0) * (ts[leaves] - ts[hits])
                     ).astype(np.int64)
    # the dilated Leave and every event after it *in sequence order* shift
    # by the accumulated extra — per thread, so a call dilated on one
    # thread never stretches calls open on the culprit's other threads,
    # and (the frame being timestamp-sorted with stable within-ts order,
    # inner leaves before outer) a nested call ending at the exact same
    # timestamp as the dilated call's Leave keeps its duration
    thread = (np.asarray(ev[THREAD], np.int64) if THREAD in ev
              else np.zeros(len(ev), np.int64))
    for t in np.unique(thread[hits]):
        rows_t = np.nonzero((proc == culprit) & (thread == t))[0]
        delta = np.zeros(len(rows_t), np.int64)
        on_t = thread[hits] == t
        pos = np.searchsorted(rows_t, leaves[on_t])
        np.add.at(delta, pos, extras[on_t])
        ts[rows_t] += np.cumsum(delta)
    rows = np.nonzero(proc == culprit)[0]
    out = _apply_ts(ev, ts)
    return out, GroundTruth(
        pathology="imbalance", detector="imbalance_root_cause",
        process=culprit, function=function, t_start=float(ts[rows].min()),
        t_end=float(ts[rows].max()), magnitude=magnitude, seed=-1)


def _inject_efficiency_drop(ev, magnitude, rng, num_windows: int = 16,
                            window: Optional[int] = None):
    """Turn computation inside one time window into waiting: a
    ``magnitude`` fraction (clipped to [0, 1]) of the non-communication
    calls entered in that window are renamed to ``MPI_Wait`` — no
    timestamp moves, so the window alignment stays exact while its
    communication efficiency collapses."""
    tr = _structured(ev)
    match = np.asarray(tr.events.column(MATCH), np.int64)
    ts = _int_ts(ev)
    edges = _window_edges(int(ts.min()), int(ts.max()), num_windows)
    w = int(num_windows // 2 if window is None else window)
    is_enter = tr.events.cat(ET).mask_eq(ENTER)
    names = ev.cat(NAME)
    comm = np.asarray([is_comm_name(c) for c in names.categories])
    cand = np.nonzero(is_enter & (match >= 0) & ~comm[names.codes]
                      & (ts >= edges[w]) & (ts < edges[w + 1]))[0]
    if len(cand) == 0:
        raise ValueError(f"window {w} has no computation to degrade")
    frac = float(np.clip(magnitude, 0.0, 1.0))
    k = max(int(round(frac * len(cand))), 1)
    hits = np.sort(rng.choice(cand, size=k, replace=False))
    new_names = np.asarray([str(s) for s in ev[NAME]], dtype=object)
    new_names[hits] = "MPI_Wait"
    new_names[match[hits]] = "MPI_Wait"
    ev[NAME] = new_names
    return _resort(ev), GroundTruth(
        pathology="efficiency_drop", detector="pop_efficiency", process=-1,
        function="", t_start=float(edges[w]), t_end=float(edges[w + 1]),
        magnitude=magnitude, seed=-1)


_INJECTORS = {
    "late_sender": _inject_late_sender,
    "straggler": _inject_straggler,
    "serialization": _inject_serialization,
    "imbalance": _inject_imbalance,
    "efficiency_drop": _inject_efficiency_drop,
}


def inject(events: Union[Trace, EventFrame], pathology: str,
           magnitude: float = 2.0, seed: int = 0,
           **kwargs) -> Tuple[EventFrame, GroundTruth]:
    """Inject ``pathology`` into a trace, returning the edited events and
    the ground truth the matching detector must recover.

    Args:
        events: source app trace (``Trace`` or raw ``EventFrame``) — never
            mutated; a fresh frame is returned.
        pathology: one of :data:`PATHOLOGIES`.
        magnitude: effect size (semantics per injector docstring);
            detector severity grows monotonically with it.
        seed: rng seed for culprit selection.
        **kwargs: injector-specific knobs (``function=`` for imbalance,
            ``window=``/``num_windows=`` for efficiency_drop, ...).

    Returns:
        ``(events, GroundTruth)``.
    """
    if pathology not in _INJECTORS:
        raise ValueError(f"unknown pathology {pathology!r}; one of "
                         f"{sorted(_INJECTORS)}")
    rng = np.random.default_rng(seed)
    out, gt = _INJECTORS[pathology](_fresh_events(events), float(magnitude),
                                    rng, **kwargs)
    return out, GroundTruth(
        pathology=gt.pathology, detector=gt.detector, process=gt.process,
        function=gt.function, t_start=gt.t_start, t_end=gt.t_end,
        magnitude=gt.magnitude, seed=seed)


def pathology_trace(pathology: str, nprocs: int = 4, iters: int = 16,
                    magnitude: float = 2.0, seed: int = 0, device="cuda",
                    **kwargs) -> Tuple[Trace, GroundTruth]:
    """Convenience: :func:`baseline` + :func:`inject` in one call, the
    trace on ``device``."""
    base = baseline(nprocs=nprocs, iters=iters, seed=seed, device="cpu")
    ev, gt = inject(base, pathology, magnitude=magnitude, seed=seed,
                    **kwargs)
    return Trace.from_events(ev, label=f"{pathology}(m={magnitude:g})",
                             device=device), gt
