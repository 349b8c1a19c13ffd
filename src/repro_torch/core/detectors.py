"""Automated diagnostics: the ``stragglers`` detector and the Findings
frame every detector returns.

Mirrors what ``stragglers`` needs of :mod:`repro.core.detectors`: the
Findings schema and builder, the comm/useful name classification, and the
detector itself on the path of the reference's ``backend="pallas"``
(``_stragglers_pallas`` and ``_StragglerAgg``): each rank's useful work —
the exclusive time of its non-communication completed calls — summed by
one ``seg_sum`` launch over the calls in canonical order, on ``device``
(the card by default, the kernel's plain version with ``device="cpu"``).
Rank time bounds stay exact int64.  The detector side-table
(``register_detector``, ``diagnose``) and the other detectors come with a
later slice (ROADMAP §A).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from . import accel
from .constants import (DEFAULT_COMM_PREFIXES, DEFAULT_IDLE_NAMES, ENTER,
                        ET, EXC, MATCH, NAME, PROC, TS)
from .frame import EventFrame
from .registry import register_op, register_streaming
from .streaming import RecordBuffer, StreamAgg, grow_to

__all__ = ["Findings", "FINDINGS_COLUMNS", "is_comm_name", "stragglers"]


# ---------------------------------------------------------------------------
# Findings frame schema
# ---------------------------------------------------------------------------

DETECTOR = "detector"
LOCATION = "location"
F_PROCESS = "process"
F_FUNCTION = "function"
SEVERITY = "severity"
T_START = "t_start"
T_END = "t_end"
EXPLANATION = "explanation"

#: column order of every Findings frame
FINDINGS_COLUMNS = (DETECTOR, LOCATION, F_PROCESS, F_FUNCTION, SEVERITY,
                    T_START, T_END, EXPLANATION)


def Findings(rows: Sequence[dict]) -> EventFrame:
    """Build a ranked Findings frame from per-finding dicts.

    Rows are sorted by severity descending (ties broken by detector name,
    then location — a total, deterministic order, so every execution route
    produces the same frame from the same sums).  ``process`` is -1 and
    ``function`` is ``""`` where not applicable.
    """
    rows = sorted(rows, key=lambda r: (-r[SEVERITY], r[DETECTOR],
                                       r[LOCATION], r[F_PROCESS]))
    return EventFrame({
        DETECTOR: np.asarray([r[DETECTOR] for r in rows], dtype=object),
        LOCATION: np.asarray([r[LOCATION] for r in rows], dtype=object),
        F_PROCESS: np.asarray([int(r.get(F_PROCESS, -1)) for r in rows],
                              np.int64),
        F_FUNCTION: np.asarray([r.get(F_FUNCTION, "") for r in rows],
                               dtype=object),
        SEVERITY: np.asarray([float(r[SEVERITY]) for r in rows], np.float64),
        T_START: np.asarray([float(r.get(T_START, 0.0)) for r in rows],
                            np.float64),
        T_END: np.asarray([float(r.get(T_END, 0.0)) for r in rows],
                          np.float64),
        EXPLANATION: np.asarray([r[EXPLANATION] for r in rows],
                                dtype=object),
    })


def _ms(ns: float) -> str:
    return f"{ns / 1e6:.3f} ms"


# ---------------------------------------------------------------------------
# comm / useful name classification
# ---------------------------------------------------------------------------

_COMM_SUBSTRINGS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute", "nccl", "send",
                    "recv")


def is_comm_name(name: str) -> bool:
    """Whether a function name is communication/wait rather than useful
    computation — one pure function of the *string*, so the eager and
    streaming routes agree by construction."""
    s = str(name)
    low = s.lower()
    return (s.startswith(DEFAULT_COMM_PREFIXES)
            or any(t in low for t in _COMM_SUBSTRINGS)
            or s in DEFAULT_IDLE_NAMES)


def _comm_cat_mask(categories) -> np.ndarray:
    return np.asarray([is_comm_name(c) for c in categories], dtype=bool)


class _NameClassCache:
    """Incrementally classify a growing GlobalNames table as comm/useful —
    streaming aggregators call this per chunk; only newly interned names
    pay the string checks."""

    def __init__(self):
        self._mask = np.zeros(0, dtype=bool)

    def mask(self, names) -> np.ndarray:
        have, want = len(self._mask), len(names)
        if want > have:
            self._mask = np.concatenate(
                [self._mask, _comm_cat_mask(names.names[have:want])])
        return self._mask[:want]


# ---------------------------------------------------------------------------
# straggler ranks
# ---------------------------------------------------------------------------

_T_MAX, _T_MIN = np.iinfo(np.int64).max, np.iinfo(np.int64).min


def _straggler_findings(work, t0, t1, nprocs, threshold):
    rows: List[dict] = []
    work = work[:nprocs]
    mean = float(work.sum()) / max(nprocs, 1)
    if mean <= 0:
        return Findings(rows)
    for p in range(nprocs):
        sev = (float(work[p]) - mean) / mean
        if sev >= threshold:
            rows.append({
                DETECTOR: "stragglers",
                LOCATION: f"rank {p}",
                F_PROCESS: int(p), F_FUNCTION: "",
                SEVERITY: sev,
                T_START: float(t0[p]), T_END: float(t1[p]),
                EXPLANATION: (
                    f"rank {p} spent {_ms(float(work[p]))} in computation "
                    f"vs a {_ms(mean)} mean across {nprocs} ranks "
                    f"({sev * 100:.1f}% above the mean)"),
            })
    return Findings(rows)


def _rank_bounds(proc: np.ndarray, ts: np.ndarray, nprocs: int):
    """Exact per-rank [first, last] event timestamps (int64 ns)."""
    t0 = np.full(nprocs, _T_MAX, np.int64)
    t1 = np.full(nprocs, _T_MIN, np.int64)
    np.minimum.at(t0, proc, ts)
    np.maximum.at(t1, proc, ts)
    return t0, t1


def _busy(acode, proc, start, end, exc, nprocs, device) -> np.ndarray:
    """Per-rank sums of ``exc`` by one ``seg_sum`` launch over the records
    in canonical order."""
    o = accel.canonical_order(start, end, proc, acode, exc)
    return accel.seg_sum(proc[o], exc[o], nprocs, device=device)


@register_op("stragglers", needs_structure=True)
def stragglers(trace, threshold: float = 0.2, device="cuda") -> EventFrame:
    """Ranks whose useful (non-communication) work is far above the mean.

    Sums exclusive time of non-communication completed calls per rank, in
    the ``seg_sum`` kernel; a rank whose total exceeds the cross-rank mean
    by ``threshold`` (relative excess, 0.2 = 20% above the mean) is
    reported — the classic straggler every collective then waits for.

    Args:
        threshold: relative excess over the cross-rank mean that flags a
            rank (-1.0 reports every rank).
        device: where the kernel runs (``"cuda"`` or ``"cpu"``).

    Returns:
        Findings frame — ``process`` is the straggler rank, the window is
        that rank's active span.
    """
    ev = trace.events
    nprocs = trace.num_processes
    if len(ev) == 0 or nprocs == 0:
        return Findings([])
    is_enter = ev.cat(ET).mask_eq(ENTER)
    comm = _comm_cat_mask(ev.cat(NAME).categories)[ev.codes(NAME)]
    match = np.asarray(ev.column(MATCH), np.int64)
    sel = np.nonzero(is_enter & ~comm & (match >= 0))[0]
    ts = np.asarray(ev[TS], np.float64)
    proc = np.asarray(ev[PROC], np.int64)
    exc = np.nan_to_num(np.asarray(ev.column(EXC), np.float64)[sel])
    _names, _order, inv = accel.alpha_positions(ev.cat(NAME).categories)
    work = _busy(inv[ev.codes(NAME)[sel]], proc[sel], ts[sel],
                 ts[match[sel]], exc, nprocs, device)
    t0, t1 = _rank_bounds(proc, np.asarray(ev[TS], np.int64), nprocs)
    return _straggler_findings(work, t0, t1, nprocs, threshold)


@register_streaming("stragglers")
class _StragglerAgg(StreamAgg):
    """Streaming stragglers: per-rank time bounds accumulated per chunk
    (exact int64), the non-comm completed calls buffered for the in-memory
    op's one ``seg_sum`` call."""

    needs_calls = True

    def __init__(self, threshold: float = 0.2, device="cuda"):
        self.threshold = float(threshold)
        self.device = device
        self._recs = RecordBuffer()
        self._t0 = np.full(0, _T_MAX, np.int64)
        self._t1 = np.full(0, _T_MIN, np.int64)
        self._classes = _NameClassCache()

    def update(self, chunk) -> None:
        ev = chunk.events
        proc = np.asarray(ev[PROC], np.int64)
        np_ = int(proc.max()) + 1
        self._t0 = grow_to(self._t0, (np_,), fill=_T_MAX)
        self._t1 = grow_to(self._t1, (np_,), fill=_T_MIN)
        ts = np.asarray(ev[TS], np.int64)
        np.minimum.at(self._t0, proc, ts)
        np.maximum.at(self._t1, proc, ts)
        calls = chunk.calls
        keep = ~self._classes.mask(chunk.names)[calls.name]
        self._recs.add(calls, np.nan_to_num(calls.exc), keep)

    def result(self, ctx) -> EventFrame:
        nprocs = ctx.num_processes
        if nprocs <= 0:
            return Findings([])
        _names, _order, inv = accel.alpha_positions(ctx.names.names)
        acode, proc, start, end, exc = self._recs.gather(inv)
        work = _busy(acode, proc, start, end, exc[:, 0], nprocs, self.device)
        t0 = grow_to(self._t0, (nprocs,), fill=_T_MAX)[:nprocs]
        t1 = grow_to(self._t1, (nprocs,), fill=_T_MIN)[:nprocs]
        return _straggler_findings(work, t0, t1, nprocs, self.threshold)
