"""Automated diagnostics: a detector registry layered on the op registry.

Mirrors :mod:`repro.core.detectors`.  A **detector** is a registered
analysis op (:func:`register_detector` wraps
:func:`~repro_torch.core.registry.register_op`) that returns a ranked
``Findings`` frame: one row per suspected problem with a location, a
severity score, the time window it covers and a human-readable
explanation.  Because detectors are ordinary registry ops they run
wherever ops do: eagerly (``trace.stragglers()``), as a lazy plan's
terminal (``trace.query().slice_time(...).diagnose()``), out of core over
streaming handles, over the parallel executor's work units (every
detector's aggregator merges across units), against packs, on live
handles, through the plan cache and through the trace-query service's
``/diagnose`` endpoint.

The detectors:

``late_sender``
    message pairs whose sender posted after the receiver was already
    waiting (and receivers that pick messages up anomalously late),
    charged to the offending rank.
``stragglers``
    ranks whose non-communication work exceeds the mean by a threshold.
    Each rank's busy sum is one ``seg_sum`` launch over the calls in
    canonical order, on ``device`` (the card by default, the kernel's
    plain version with ``device="cpu"``), the reference's
    ``backend="pallas"`` path.
``serialization``
    processes where one thread holds nearly all the busy time.
``imbalance_root_cause``
    the functions that drive load imbalance: per-function cross-rank
    max-minus-mean cost, charged to the dominant rank.
``pop_efficiency``
    time windows whose POP parallel efficiency
    (:func:`efficiency_metrics`) drops well below the trace's own median.

Every detector but ``stragglers`` stays host NumPy: its severities come
from integer-nanosecond sums, so every route gives the same bits (on
traces with integer timestamps, as the reference promises).  The
reference's streaming forms of ``late_sender`` and the POP pair take
their span from a statistics pre-pass; the port's aggregators track the
span of the masked chunks themselves and buffer the call records, fixing
window edges in ``result`` — the span the pre-pass would read, with no
second read of the stream, so the live incremental fold stays usable.
With a handle's ``fold="chunks"`` every detector, ``efficiency_metrics``
and ``diagnose`` keep bounded state instead: the POP pair sums each
chunk's calls into per-(window, rank) totals on edges from the
statistics pre-pass, ``stragglers`` launches ``seg_sum`` once a chunk,
and ``late_sender``, ``serialization`` and ``imbalance_root_cause`` keep
the state they already keep, which is the reference's.  Each takes
``device=`` like every op; a host detector only checks it (the card
asked for without one raises) and the plan cache keys on it.
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from . import accel
from .accel import resolve_device
from .constants import (DEFAULT_COMM_PREFIXES, DEFAULT_IDLE_NAMES, ENTER,
                        ET, EXC, INC, LEAVE, MATCH, MPI_RECV, MPI_SEND, NAME,
                        PARTNER, PROC, TAG, THREAD, TS)
from .frame import EventFrame
from .registry import (call_with_device, get_op, register_op,
                       register_streaming)
from .streaming import (FoldAgg, RecordBuffer, StreamAgg,
                        StreamingUnsupported, add_into, grow_to, make_agg)

__all__ = ["DetectorSpec", "register_detector", "get_detector",
           "list_detectors", "Findings", "FINDINGS_COLUMNS", "is_comm_name",
           "late_sender", "stragglers", "serialization",
           "imbalance_root_cause", "pop_efficiency", "efficiency_metrics",
           "diagnose"]


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
# detector registry (layered on the op registry)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DetectorSpec:
    """What the detector layer keeps beside the op registry entry: the
    pathology category, the default severity threshold (findings below it
    are suppressed) and a one-line description."""

    name: str
    fn: Callable
    category: str
    threshold: float
    description: str


_DETECTOR_REGISTRY: Dict[str, DetectorSpec] = {}


def register_detector(name: str, *, category: str, threshold: float,
                      needs_structure: bool = False,
                      needs_messages: bool = False) -> Callable:
    """Register ``fn(trace, ...) -> Findings`` as a detector: an ordinary
    ``scope="trace"`` op (a lazy-query terminal, served, cached, and, once
    ``register_streaming`` attaches an aggregator, out of core and
    parallel) that :func:`diagnose` also enumerates.  ``fn`` gets
    ``device=`` only if it takes it (:func:`~repro_torch.core.registry.
    call_with_device`), as the built-in detectors do."""
    def deco(fn: Callable) -> Callable:
        wrapped = register_op(name, needs_structure=needs_structure,
                              needs_messages=needs_messages)(fn)
        doc = inspect.getdoc(fn)
        desc = doc.splitlines()[0].rstrip() if doc else ""
        _DETECTOR_REGISTRY[name] = DetectorSpec(
            name=name, fn=fn, category=category, threshold=float(threshold),
            description=desc)
        return wrapped
    return deco


def get_detector(name: str) -> Optional[DetectorSpec]:
    """The DetectorSpec for ``name``, or None if the op is not a detector."""
    return _DETECTOR_REGISTRY.get(name)


def list_detectors() -> List[str]:
    """Registered detector names, sorted."""
    return sorted(_DETECTOR_REGISTRY)


_T_MAX, _T_MIN = np.iinfo(np.int64).max, np.iinfo(np.int64).min


class _SpanAgg(StreamAgg):
    """Base of the aggregators that need the span of the masked stream:
    ``update`` keeps the least and greatest timestamp of each chunk's
    events (int64 ns; a seam block of the parallel merge has none) and
    ``merge_from`` combines them — what the reference's statistics
    pre-pass reads in a second pass."""

    supports_parallel = True

    def __init__(self):
        self._t0, self._t1 = _T_MAX, _T_MIN

    def _track(self, ev) -> None:
        if len(ev):
            ts = np.asarray(ev[TS], np.int64)
            self._t0 = min(self._t0, int(ts.min()))
            self._t1 = max(self._t1, int(ts.max()))

    def _merge_span(self, other) -> None:
        self._t0 = min(self._t0, other._t0)
        self._t1 = max(self._t1, other._t1)

    @property
    def _seen(self) -> bool:
        return self._t0 <= self._t1


def _fifo_pairs(s_ts, s_src, s_dst, s_tag, r_ts, r_src, r_dst, r_tag):
    """FIFO-match send/recv instants per (src, dst, tag) channel, as
    :func:`repro_torch.core.structure.match_messages` does: both sides
    sorted by timestamp within a channel, k-th send paired with k-th recv.

    Returns ``(send_ts, recv_ts, src, dst)`` of the matched pairs
    (channel-major order; every consumer aggregates, so only the
    *multiset* of pairs matters, and it is the in-memory matching's).
    """
    if len(s_ts) == 0 or len(r_ts) == 0:
        z = np.empty(0, np.int64)
        return z, z, z.copy(), z.copy()
    hi = int(max(s_src.max(), s_dst.max(), r_src.max(), r_dst.max())) + 1
    ht = int(max(s_tag.max() if len(s_tag) else 0,
                 r_tag.max() if len(r_tag) else 0)) + 2
    s_key = (s_src * hi + s_dst) * ht + s_tag
    r_key = (r_src * hi + r_dst) * ht + r_tag
    so = np.lexsort((s_ts, s_key))
    ro = np.lexsort((r_ts, r_key))
    s_key, s_ts, s_src, s_dst = s_key[so], s_ts[so], s_src[so], s_dst[so]
    r_key, r_ts = r_key[ro], r_ts[ro]
    out_s, out_r, out_src, out_dst = [], [], [], []
    keys = np.unique(np.concatenate([s_key, r_key]))
    for k in keys:
        si = np.nonzero(s_key == k)[0]
        ri = np.nonzero(r_key == k)[0]
        m = min(len(si), len(ri))
        if m == 0:
            continue
        out_s.append(s_ts[si[:m]])
        out_r.append(r_ts[ri[:m]])
        out_src.append(s_src[si[:m]])
        out_dst.append(s_dst[si[:m]])
    if not out_s:
        z = np.empty(0, np.int64)
        return z, z, z.copy(), z.copy()
    return (np.concatenate(out_s), np.concatenate(out_r),
            np.concatenate(out_src), np.concatenate(out_dst))


def _late_findings(send_ts, recv_ts, src, dst, span, nprocs, threshold,
                   late_recv_margin):
    """Shared eager/streaming finalization for :func:`late_sender` —
    everything integer-ns until the final severity division."""
    rows: List[dict] = []
    if len(send_ts) == 0 or span <= 0:
        return Findings(rows)
    # -- late sender: message posted after the receiver reached its recv
    wait = np.maximum(send_ts - recv_ts, 0)
    tot = np.zeros(nprocs, np.int64)
    cnt = np.zeros(nprocs, np.int64)
    w0 = np.full(nprocs, _T_MAX, np.int64)
    w1 = np.full(nprocs, _T_MIN, np.int64)
    late = wait > 0
    np.add.at(tot, src[late], wait[late])
    np.add.at(cnt, src[late], 1)
    np.minimum.at(w0, src[late], send_ts[late])
    np.maximum.at(w1, src[late], send_ts[late])
    for p in range(nprocs):
        sev = float(tot[p]) / float(span)
        if sev >= threshold:
            rows.append({
                DETECTOR: "late_sender",
                LOCATION: f"rank {p} (sender)",
                F_PROCESS: int(p), F_FUNCTION: MPI_SEND,
                SEVERITY: sev,
                T_START: float(w0[p]), T_END: float(w1[p]),
                EXPLANATION: (
                    f"{int(cnt[p])} messages from rank {p} were posted "
                    f"after their receiver was already waiting "
                    f"({_ms(float(tot[p]))} total receiver wait, "
                    f"{sev * 100:.1f}% of the trace span)"),
            })
    # -- late receiver: pick-up lag far beyond the trace's typical lag
    lag = np.maximum(recv_ts - send_ts, 0)
    med = int(np.floor(np.median(lag)))
    cut = int(late_recv_margin * med)
    if cut > 0:
        excess = np.maximum(lag - cut, 0)
        rtot = np.zeros(nprocs, np.int64)
        rcnt = np.zeros(nprocs, np.int64)
        r0 = np.full(nprocs, _T_MAX, np.int64)
        r1 = np.full(nprocs, _T_MIN, np.int64)
        slow = excess > 0
        np.add.at(rtot, dst[slow], excess[slow])
        np.add.at(rcnt, dst[slow], 1)
        np.minimum.at(r0, dst[slow], recv_ts[slow])
        np.maximum.at(r1, dst[slow], recv_ts[slow])
        for p in range(nprocs):
            sev = float(rtot[p]) / float(span)
            if sev >= threshold:
                rows.append({
                    DETECTOR: "late_sender",
                    LOCATION: f"rank {p} (receiver)",
                    F_PROCESS: int(p), F_FUNCTION: MPI_RECV,
                    SEVERITY: sev,
                    T_START: float(r0[p]), T_END: float(r1[p]),
                    EXPLANATION: (
                        f"rank {p} picked up {int(rcnt[p])} messages "
                        f"{late_recv_margin:g}x later than the typical "
                        f"send-to-recv lag ({_ms(float(med))}), "
                        f"{_ms(float(rtot[p]))} excess in total"),
                })
    return Findings(rows)


# ---------------------------------------------------------------------------
# detector 1: late sender / late receiver
# ---------------------------------------------------------------------------

@register_detector("late_sender", category="communication", threshold=0.01,
                   needs_messages=True)
def late_sender(trace, threshold: float = 0.01,
                late_recv_margin: float = 4.0, device="cuda") -> EventFrame:
    """Message pairs whose sender posted late (receiver sat waiting) or
    whose receiver picked up anomalously late.

    For every FIFO-matched MpiSend/MpiRecv pair: if the send instant comes
    *after* the matched recv instant, the receiver reached its receive
    point first and idled for ``send_ts - recv_ts`` — that wait is charged
    to the sending rank.  Symmetrically, a pair whose pick-up lag
    (``recv_ts - send_ts``) exceeds ``late_recv_margin`` times the trace's
    median lag charges the excess to the receiving rank.

    Args:
        threshold: minimum severity (total charged wait as a fraction of
            the trace span) for a rank to be reported.
        late_recv_margin: multiple of the median send-to-recv lag beyond
            which a receiver counts as late.
        device: the op's device (host NumPy either way).

    Returns:
        Findings frame — ``process`` is the offending rank, ``function``
        is ``MpiSend`` (late sender) or ``MpiRecv`` (late receiver), the
        window spans the offending messages.
    """
    resolve_device(device)
    ev = trace.events
    n = len(ev)
    rows: List[dict] = []
    mm = getattr(trace, "_msg_match", None)
    if n == 0 or mm is None:
        return Findings(rows)
    ts = np.asarray(ev[TS], np.int64)
    name = ev.cat(NAME)
    sends = np.nonzero(name.mask_eq(MPI_SEND) & (mm >= 0))[0]
    if len(sends) == 0:
        return Findings(rows)
    proc = np.asarray(ev[PROC], np.int64)
    send_ts = ts[sends]
    recv_ts = ts[mm[sends]]
    src = proc[sends]
    dst = proc[mm[sends]]
    span = int(ts.max()) - int(ts.min())
    return _late_findings(send_ts, recv_ts, src, dst, span,
                          trace.num_processes, threshold, late_recv_margin)


@register_streaming("late_sender")
class _LateSenderAgg(_SpanAgg):
    """Collects send/recv instants per chunk (compact column arrays) and
    FIFO-matches them in ``result`` — memory is O(#messages), the pairing
    multiset is ``match_messages``'s, and the severities are integer-ns
    sums over the span of the masked chunks, so every route gives the
    eager bits."""

    def __init__(self, threshold: float = 0.01,
                 late_recv_margin: float = 4.0, device="cuda"):
        super().__init__()
        self.threshold = float(threshold)
        self.late_recv_margin = float(late_recv_margin)
        self.device = device
        self._sends: List[np.ndarray] = []
        self._recvs: List[np.ndarray] = []

    @staticmethod
    def _grab(mask, ts, proc, partner, tag, into) -> None:
        rows = np.nonzero(mask)[0]
        if len(rows):
            into.append(np.stack([ts[rows], proc[rows], partner[rows],
                                  tag[rows]]))

    def update(self, chunk) -> None:
        ev = chunk.events
        self._track(ev)
        if PARTNER not in ev or len(ev) == 0:
            return
        name = ev.cat(NAME)
        is_send = name.mask_eq(MPI_SEND)
        is_recv = name.mask_eq(MPI_RECV)
        if not (is_send.any() or is_recv.any()):
            return
        ts = np.asarray(ev[TS], np.int64)
        proc = np.asarray(ev[PROC], np.int64)
        partner = np.asarray(ev[PARTNER], np.int64)
        tag = (np.asarray(ev[TAG], np.int64) if TAG in ev
               else np.zeros(len(ev), np.int64))
        self._grab(is_send, ts, proc, partner, tag, self._sends)
        self._grab(is_recv, ts, proc, partner, tag, self._recvs)

    def merge_from(self, other, code_map) -> None:
        self._merge_span(other)
        self._sends.extend(other._sends)
        self._recvs.extend(other._recvs)

    def result(self, ctx) -> EventFrame:
        if not self._sends or not self._recvs:
            return Findings([])
        s = np.concatenate(self._sends, axis=1)
        r = np.concatenate(self._recvs, axis=1)
        send_ts, recv_ts, src, dst = _fifo_pairs(
            s[0], s[1], s[2], s[3], r[0], r[2], r[1], r[3])
        return _late_findings(send_ts, recv_ts, src, dst,
                              self._t1 - self._t0, ctx.num_processes,
                              self.threshold, self.late_recv_margin)

    def fold_form(self):
        """Its own ``fold="chunks"`` form: the compact send / recv instants
        it keeps are the reference's state, O(#messages) in both packages,
        since the late-receiver half needs the median lag over every
        matched pair."""
        return self


# ---------------------------------------------------------------------------
# detector 2: straggler ranks
# ---------------------------------------------------------------------------

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


@register_detector("stragglers", category="imbalance", threshold=0.2,
                   needs_structure=True)
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


class _RankBounds:
    """Exact per-rank [first, last] event timestamps (int64), kept chunk
    by chunk and merged across work units by min and max."""

    def update_bounds(self, chunk) -> None:
        ev = chunk.events
        proc = np.asarray(ev[PROC], np.int64)
        if len(proc):  # a seam block of the parallel merge has no events
            self._widen(int(proc.max()) + 1)
            ts = np.asarray(ev[TS], np.int64)
            np.minimum.at(self._t0, proc, ts)
            np.maximum.at(self._t1, proc, ts)

    def _widen(self, nprocs: int) -> None:
        self._t0 = grow_to(self._t0, (nprocs,), fill=_T_MAX)
        self._t1 = grow_to(self._t1, (nprocs,), fill=_T_MIN)

    def merge_bounds(self, other, code_map) -> None:
        n = len(other._t0)
        if n:
            self._widen(n)
            np.minimum(self._t0[:n], other._t0, out=self._t0[:n])
            np.maximum(self._t1[:n], other._t1, out=self._t1[:n])


@register_streaming("stragglers")
class _StragglerAgg(_RankBounds, StreamAgg):
    """Streaming stragglers: per-rank time bounds accumulated per chunk
    (exact int64), the non-comm completed calls buffered for the in-memory
    op's one ``seg_sum`` call."""

    needs_calls = True
    supports_parallel = True

    def __init__(self, threshold: float = 0.2, device="cuda"):
        self.threshold = float(threshold)
        self.device = device
        self._recs = RecordBuffer()
        self._t0 = np.full(0, _T_MAX, np.int64)
        self._t1 = np.full(0, _T_MIN, np.int64)
        self._classes = _NameClassCache()

    def update(self, chunk) -> None:
        self.update_bounds(chunk)
        calls = chunk.calls
        keep = ~self._classes.mask(chunk.names)[calls.name]
        self._recs.add(calls, np.nan_to_num(calls.exc), keep)

    def merge_from(self, other, code_map) -> None:
        """Per-rank bounds by min and max, records appended (a unit's
        records were kept by its own name classes, the same names')."""
        self.merge_bounds(other, code_map)
        self._recs.merge(other._recs, code_map)

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

    def fold_form(self):
        return _StragglerFold(self.threshold, self.device)


class _StragglerFold(_RankBounds, FoldAgg):
    """``stragglers`` folded a chunk at a time: per-rank time bounds
    (exact int64, as the buffering form keeps them) and, per chunk, one
    ``seg_sum`` launch of its non-comm calls' exclusive time by rank,
    added into float64 busy sums.  Mirrors the reference's
    ``_StragglerAgg`` with ``backend="numpy"``."""

    needs_calls = True

    def __init__(self, threshold: float, device):
        super().__init__(device)
        self.threshold = threshold
        self._work = np.zeros(0)
        self._t0 = np.full(0, _T_MAX, np.int64)
        self._t1 = np.full(0, _T_MIN, np.int64)
        self._classes = _NameClassCache()

    def observe(self, chunk) -> None:
        self.update_bounds(chunk)

    def merge_host(self, other, code_map) -> None:
        self.merge_bounds(other, code_map)

    def records(self, chunk):
        calls = chunk.calls
        keep = ~self._classes.mask(chunk.names)[calls.name]
        if not keep.any():
            return None
        return calls.proc[keep], np.nan_to_num(calls.exc[keep])

    def fold(self, part) -> None:
        proc, exc = part
        self._work = add_into(self._work, accel.seg_sum(
            proc, exc, int(proc.max()) + 1, device=self.device))

    def result(self, ctx) -> EventFrame:
        nprocs = ctx.num_processes
        if nprocs <= 0:
            return Findings([])
        work = np.zeros(nprocs)
        n = min(nprocs, len(self._work))
        work[:n] = self._work[:n]
        t0 = grow_to(self._t0, (nprocs,), fill=_T_MAX)[:nprocs]
        t1 = grow_to(self._t1, (nprocs,), fill=_T_MIN)[:nprocs]
        return _straggler_findings(work, t0, t1, nprocs, self.threshold)


# ---------------------------------------------------------------------------
# detector 3: serialization on one thread
# ---------------------------------------------------------------------------

def _serialization_findings(busy, nev, t0, t1, threshold, min_threads):
    rows: List[dict] = []
    nprocs, _nthreads = busy.shape
    for p in range(nprocs):
        active = np.nonzero(nev[p] > 0)[0]
        if len(active) < min_threads:
            continue
        b = np.maximum(busy[p, active].astype(np.float64), 0.0)
        total = float(b.sum())
        if total <= 0:
            continue
        k = int(np.argmax(b))
        share = float(b[k]) / total
        nt = len(active)
        sev = (share - 1.0 / nt) / (1.0 - 1.0 / nt)
        if sev >= threshold:
            t = int(active[k])
            rows.append({
                DETECTOR: "serialization",
                LOCATION: f"rank {p} thread {t}",
                F_PROCESS: int(p), F_FUNCTION: "",
                SEVERITY: sev,
                T_START: float(t0[p]), T_END: float(t1[p]),
                EXPLANATION: (
                    f"thread {t} holds {share * 100:.1f}% of rank {p}'s "
                    f"busy time across {nt} threads — work meant to "
                    f"overlap is serialized on one thread"),
            })
    return Findings(rows)


@register_detector("serialization", category="concurrency", threshold=0.85)
def serialization(trace, threshold: float = 0.85, min_threads: int = 2,
                  device="cuda") -> EventFrame:
    """Processes where one thread carries nearly all the busy time.

    Busy time per (process, thread) is the nesting-weighted call time
    ``sum(leave timestamps) - sum(enter timestamps)`` — exact, additive,
    and needing no derived structure.  For processes with at least
    ``min_threads`` active threads, the dominant thread's share is
    normalized against a perfectly balanced split: severity
    ``(share - 1/T) / (1 - 1/T)`` is 0 when threads share evenly and 1
    when a single thread does everything.  Traces without a thread column
    produce no findings.

    Returns:
        Findings frame — ``process`` is the serialized rank; the location
        names the dominant thread.
    """
    resolve_device(device)
    ev = trace.events
    if len(ev) == 0 or THREAD not in ev:
        return Findings([])
    et = ev.cat(ET)
    is_enter = et.mask_eq(ENTER)
    is_leave = et.mask_eq(LEAVE)
    proc = np.asarray(ev[PROC], np.int64)
    thread = np.asarray(ev[THREAD], np.int64)
    nprocs = trace.num_processes
    busy = np.zeros((nprocs, int(thread.max()) + 1), np.int64)
    nev = np.zeros_like(busy)
    ts = np.asarray(ev[TS], np.int64)
    sign = np.where(is_leave, 1, -1).astype(np.int64)
    rows = np.nonzero(is_enter | is_leave)[0]
    np.add.at(busy, (proc[rows], thread[rows]), ts[rows] * sign[rows])
    np.add.at(nev, (proc[rows], thread[rows]), 1)
    t0, t1 = _rank_bounds(proc, ts, nprocs)
    return _serialization_findings(busy, nev, t0, t1, threshold, min_threads)


@register_streaming("serialization")
class _SerializationAgg(StreamAgg):
    """Signed-timestamp accumulation per (process, thread): each chunk adds
    ``sum(leave ts) - sum(enter ts)`` — int64-exact and order-independent,
    so chunk boundaries and unit merges cannot change the result."""

    supports_parallel = True

    def __init__(self, threshold: float = 0.85, min_threads: int = 2,
                 device="cuda"):
        self.threshold = float(threshold)
        self.min_threads = int(min_threads)
        self.device = device
        self._busy = np.zeros((0, 0), np.int64)
        self._nev = np.zeros((0, 0), np.int64)
        self._t0 = np.full(0, _T_MAX, np.int64)
        self._t1 = np.full(0, _T_MIN, np.int64)

    def _widen(self, nprocs: int) -> None:
        self._t0 = grow_to(self._t0, (nprocs,), fill=_T_MAX)
        self._t1 = grow_to(self._t1, (nprocs,), fill=_T_MIN)

    def update(self, chunk) -> None:
        ev = chunk.events
        if len(ev) == 0 or THREAD not in ev:
            return
        proc = np.asarray(ev[PROC], np.int64)
        ts = np.asarray(ev[TS], np.int64)
        np_ = int(proc.max()) + 1
        self._widen(np_)
        np.minimum.at(self._t0, proc, ts)
        np.maximum.at(self._t1, proc, ts)
        et = ev.cat(ET)
        is_enter = et.mask_eq(ENTER)
        is_leave = et.mask_eq(LEAVE)
        rows = np.nonzero(is_enter | is_leave)[0]
        if len(rows) == 0:
            return
        thread = np.asarray(ev[THREAD], np.int64)
        nt = int(thread[rows].max()) + 1
        self._busy = grow_to(self._busy, (np_, nt))
        self._nev = grow_to(self._nev, (np_, nt))
        sign = np.where(is_leave[rows], 1, -1).astype(np.int64)
        np.add.at(self._busy, (proc[rows], thread[rows]), ts[rows] * sign)
        np.add.at(self._nev, (proc[rows], thread[rows]), 1)

    def merge_from(self, other, code_map) -> None:
        shape = (max(self._busy.shape[0], other._busy.shape[0]),
                 max(self._busy.shape[1], other._busy.shape[1]))
        self._busy = grow_to(self._busy, shape)
        self._nev = grow_to(self._nev, shape)
        op, ot = other._busy.shape
        self._busy[:op, :ot] += other._busy
        self._nev[:op, :ot] += other._nev
        n = len(other._t0)
        if n:
            self._widen(n)
            np.minimum(self._t0[:n], other._t0, out=self._t0[:n])
            np.maximum(self._t1[:n], other._t1, out=self._t1[:n])

    def result(self, ctx) -> EventFrame:
        nprocs = ctx.num_processes
        if nprocs <= 0 or self._nev.size == 0:
            return Findings([])
        nthreads = self._nev.shape[1]
        busy = np.zeros((nprocs, nthreads), np.int64)
        nev = np.zeros((nprocs, nthreads), np.int64)
        p = min(nprocs, self._busy.shape[0])
        busy[:p] = self._busy[:p, :nthreads]
        nev[:p] = self._nev[:p, :nthreads]
        t0 = grow_to(self._t0, (nprocs,), fill=_T_MAX)[:nprocs]
        t1 = grow_to(self._t1, (nprocs,), fill=_T_MIN)[:nprocs]
        return _serialization_findings(busy, nev, t0, t1, self.threshold,
                                       self.min_threads)

    def fold_form(self):
        """Its own ``fold="chunks"`` form: per-(process, thread) int64 sums
        and per-rank bounds, the reference's state, fixed in size."""
        return self


# ---------------------------------------------------------------------------
# detector 4: load-imbalance root cause
# ---------------------------------------------------------------------------

def _imbalance_findings(names, tot, nprocs, t0, t1, threshold, top_n):
    rows: List[dict] = []
    if nprocs <= 0 or tot.size == 0:
        return Findings(rows)
    mean_work = float(tot.sum()) / nprocs
    if mean_work <= 0:
        return Findings(rows)
    per_mean = tot.sum(axis=1) / nprocs
    per_max = tot.max(axis=1)
    culprit = np.argmax(tot, axis=1)
    cost = per_max - per_mean
    sev = cost / mean_work
    order = np.argsort(-sev, kind="stable")
    if top_n is not None:
        order = order[:top_n]
    for f in order:
        if sev[f] < threshold:
            break
        p = int(culprit[f])
        ratio = (float(per_max[f]) / per_mean[f]) if per_mean[f] > 0 else 0.0
        rows.append({
            DETECTOR: "imbalance_root_cause",
            LOCATION: f"{names[f]} @ rank {p}",
            F_PROCESS: p, F_FUNCTION: str(names[f]),
            SEVERITY: float(sev[f]),
            T_START: float(t0), T_END: float(t1),
            EXPLANATION: (
                f"{names[f]} is {ratio:.2f}x imbalanced: rank {p} spends "
                f"{_ms(float(per_max[f]))} vs a {_ms(float(per_mean[f]))} "
                f"cross-rank mean — {_ms(float(cost[f]))} of imbalance "
                f"cost ({sev[f] * 100:.1f}% of mean rank work)"),
        })
    return Findings(rows)


@register_detector("imbalance_root_cause", category="imbalance",
                   threshold=0.05, needs_structure=True)
def imbalance_root_cause(trace, threshold: float = 0.05, metric: str = EXC,
                         top_n: Optional[int] = None,
                         device="cuda") -> EventFrame:
    """Which functions drive load imbalance, and on which rank.

    For every function, sums the metric per rank; the imbalance *cost* of a
    function is ``max-over-ranks - mean-over-ranks`` (the time the busiest
    rank makes everyone else wait, were they to synchronize).  Severity
    normalizes that cost by the mean per-rank total work, so 0.10 means
    this one function costs 10% of a rank's work in imbalance.

    Args:
        threshold: minimum severity to report.
        metric: ``time.exc`` (default) or ``time.inc``.
        top_n: report at most N functions (None = all above threshold).

    Returns:
        Findings frame — ``function`` names the root cause, ``process``
        the dominant rank.
    """
    resolve_device(device)
    ev = trace.events
    nprocs = trace.num_processes
    if len(ev) == 0 or nprocs == 0:
        return Findings([])
    ent = np.nonzero(ev.cat(ET).mask_eq(ENTER))[0]
    vals = np.nan_to_num(np.asarray(ev.column(metric), np.float64)[ent])
    names = ev.codes(NAME)[ent]
    procs = np.asarray(ev[PROC], np.int64)[ent]
    cats = [str(c) for c in ev.cat(NAME).categories]
    tot = np.zeros((len(cats), nprocs))
    np.add.at(tot, (names, procs), vals)
    ts = np.asarray(ev[TS], np.int64)
    return _imbalance_findings(cats, tot, nprocs, int(ts.min()),
                               int(ts.max()), threshold, top_n)


@register_streaming("imbalance_root_cause")
class _ImbalanceRootCauseAgg(_SpanAgg):
    """Per-(function, rank) metric sums over completed calls — the
    load_imbalance accumulator with a findings finalizer."""

    needs_calls = True

    def __init__(self, threshold: float = 0.05, metric: str = EXC,
                 top_n: Optional[int] = None, device="cuda"):
        super().__init__()
        if metric not in (INC, EXC):
            raise StreamingUnsupported(
                f"streaming imbalance_root_cause supports metrics "
                f"{(INC, EXC)}, got {metric!r}")
        self.threshold = float(threshold)
        self.metric = metric
        self.top_n = top_n
        self.device = device
        self._tot = np.zeros((0, 0))

    def update(self, chunk) -> None:
        self._track(chunk.events)
        calls = chunk.calls
        if calls is None or len(calls.proc) == 0:
            return
        np_ = int(calls.proc.max()) + 1
        self._tot = grow_to(self._tot, (len(chunk.names), np_))
        vals = calls.exc if self.metric == EXC else calls.inc
        np.add.at(self._tot, (calls.name, calls.proc), vals)

    def merge_from(self, other, code_map) -> None:
        from .ops_summary import _scatter_names
        self._tot = _scatter_names(self._tot, other._tot, code_map, axis=0)
        self._merge_span(other)

    def result(self, ctx) -> EventFrame:
        nf = len(ctx.names)
        nprocs = ctx.num_processes
        if nf == 0 or nprocs <= 0:
            return Findings([])
        from .ops_summary import _pad_to
        tot = _pad_to(self._tot, (nf, nprocs))
        return _imbalance_findings(ctx.names.names, tot, nprocs, self._t0,
                                   self._t1, self.threshold, self.top_n)

    def fold_form(self):
        """Its own ``fold="chunks"`` form: per-(name, process) float64
        sums, the reference's state, fixed in size."""
        return self


# ---------------------------------------------------------------------------
# detector 5: time-resolved POP efficiency
# ---------------------------------------------------------------------------

def _window_edges(t0: int, t1: int, num_windows: int) -> np.ndarray:
    """Integer window edges over [t0, t1] — exact and identical however
    the bounds were obtained."""
    span = max(int(t1) - int(t0), 1)
    k = np.arange(num_windows + 1, dtype=np.int64)
    return int(t0) + (span * k) // num_windows


def _efficiency_frame(edges, useful, comm, nprocs) -> EventFrame:
    """Per-window POP metrics from exact per-(window, rank) ns sums.

    * load-balance efficiency = mean-over-ranks / max-over-ranks useful ns
    * communication efficiency = useful ns / (useful + communication) ns
    * parallel efficiency = the product

    Windows with no activity report 1.0 across the board (nothing ran, so
    nothing was inefficient).  Each call's exclusive time is attributed to
    the window containing its Enter timestamp, keeping every sum
    integer-exact.
    """
    nw = len(edges) - 1
    u_mean = useful.sum(axis=1) / max(nprocs, 1)
    u_max = useful.max(axis=1) if nprocs else np.zeros(nw)
    busy = useful.sum(axis=1) + comm.sum(axis=1)
    lb = np.where(u_max > 0, u_mean / np.maximum(u_max, 1e-30), 1.0)
    ce = np.where(busy > 0, useful.sum(axis=1) / np.maximum(busy, 1e-30),
                  1.0)
    pe = lb * ce
    return EventFrame({
        "window": np.arange(nw, dtype=np.int64),
        T_START: edges[:-1].astype(np.float64),
        T_END: edges[1:].astype(np.float64),
        "parallel_eff": np.clip(pe, 0.0, 1.0),
        "load_balance_eff": np.clip(lb, 0.0, 1.0),
        "comm_eff": np.clip(ce, 0.0, 1.0),
        "useful_ns": useful.sum(axis=1),
        "comm_ns": comm.sum(axis=1),
    })


def _empty_efficiency() -> EventFrame:
    return _efficiency_frame(np.asarray([0, 1], np.int64), np.zeros((1, 1)),
                             np.zeros((1, 1)), 1)


def _accumulate_windows(edges, start, proc, exc, comm_mask, nprocs):
    nw = len(edges) - 1
    useful = np.zeros((nw, nprocs))
    comm = np.zeros((nw, nprocs))
    w = np.clip(np.searchsorted(edges, start, side="right") - 1, 0, nw - 1)
    np.add.at(useful, (w[~comm_mask], proc[~comm_mask]), exc[~comm_mask])
    np.add.at(comm, (w[comm_mask], proc[comm_mask]), exc[comm_mask])
    return useful, comm


@register_op("efficiency_metrics", needs_structure=True)
def efficiency_metrics(trace, num_windows: int = 16,
                       device="cuda") -> EventFrame:
    """Time-resolved POP efficiency metrics (arxiv 2512.01764).

    Splits the trace span into ``num_windows`` equal windows and reports,
    per window, parallel / load-balance / communication efficiency — all
    in [0, 1] — plus the raw useful and communication ns.  Each call's
    exclusive time counts toward the window containing its Enter timestamp
    and is classed communication or useful by name (:func:`is_comm_name`).

    Returns:
        EventFrame with ``window``, ``t_start``, ``t_end``,
        ``parallel_eff``, ``load_balance_eff``, ``comm_eff``,
        ``useful_ns``, ``comm_ns`` — one row per window, in time order.
    """
    resolve_device(device)
    ev = trace.events
    nprocs = trace.num_processes
    num_windows = int(num_windows)
    if len(ev) == 0 or nprocs == 0 or num_windows <= 0:
        return _empty_efficiency()
    ts = np.asarray(ev[TS], np.int64)
    edges = _window_edges(int(ts.min()), int(ts.max()), num_windows)
    ent = np.nonzero(ev.cat(ET).mask_eq(ENTER))[0]
    exc = np.nan_to_num(np.asarray(ev.column(EXC), np.float64)[ent])
    comm = _comm_cat_mask(ev.cat(NAME).categories)[ev.codes(NAME)[ent]]
    useful, comm_t = _accumulate_windows(
        edges, ts[ent], np.asarray(ev[PROC], np.int64)[ent], exc, comm,
        nprocs)
    return _efficiency_frame(edges, useful, comm_t, nprocs)


def _pop_findings(metrics: EventFrame, threshold: float) -> EventFrame:
    rows: List[dict] = []
    pe = np.asarray(metrics["parallel_eff"], np.float64)
    busy = (np.asarray(metrics["useful_ns"], np.float64)
            + np.asarray(metrics["comm_ns"], np.float64))
    active = busy > 0
    if not active.any():
        return Findings(rows)
    med = float(np.median(pe[active]))
    if med <= 0:
        return Findings(rows)
    lb = np.asarray(metrics["load_balance_eff"], np.float64)
    ce = np.asarray(metrics["comm_eff"], np.float64)
    t0 = np.asarray(metrics[T_START], np.float64)
    t1 = np.asarray(metrics[T_END], np.float64)
    win = np.asarray(metrics["window"], np.int64)
    for i in np.nonzero(active)[0]:
        sev = max(0.0, (med - float(pe[i])) / med)
        if sev >= threshold:
            rows.append({
                DETECTOR: "pop_efficiency",
                LOCATION: f"window {int(win[i])}",
                F_PROCESS: -1, F_FUNCTION: "",
                SEVERITY: sev,
                T_START: float(t0[i]), T_END: float(t1[i]),
                EXPLANATION: (
                    f"window {int(win[i])} parallel efficiency "
                    f"{pe[i] * 100:.1f}% vs a {med * 100:.1f}% trace "
                    f"median (load balance {lb[i] * 100:.1f}%, "
                    f"communication {ce[i] * 100:.1f}%)"),
            })
    return Findings(rows)


@register_detector("pop_efficiency", category="efficiency", threshold=0.1,
                   needs_structure=True)
def pop_efficiency(trace, threshold: float = 0.1, num_windows: int = 16,
                   device="cuda") -> EventFrame:
    """Time windows whose parallel efficiency collapses below the trace's
    own median.

    Computes :func:`efficiency_metrics` and flags every active window
    whose parallel efficiency falls relatively ``threshold`` below the
    median over active windows — a self-calibrating gate, so steady
    (even steadily mediocre) traces produce no findings and genuine
    phase-local drops stand out.

    Returns:
        Findings frame — one row per flagged window, with the POP metrics
        spelled out in the explanation.
    """
    return _pop_findings(efficiency_metrics(trace, num_windows=num_windows,
                                            device=device), threshold)


@register_streaming("efficiency_metrics")
class _EfficiencyMetricsAgg(_SpanAgg):
    """Streaming :func:`efficiency_metrics`: the span of the masked chunks
    tracked per chunk, each completed call's (enter ts, process,
    exclusive ns, comm flag) buffered, and the windows cut and summed in
    ``result`` — exact per-(window, rank) ns sums, as in memory."""

    needs_calls = True

    def __init__(self, num_windows: int = 16, device="cuda"):
        super().__init__()
        self.num_windows = int(num_windows)
        self.device = device
        self._recs: List[tuple] = []
        self._classes = _NameClassCache()

    def update(self, chunk) -> None:
        self._track(chunk.events)
        calls = chunk.calls
        if calls is None or len(calls.proc) == 0:
            return
        self._recs.append((np.asarray(calls.start, np.int64), calls.proc,
                           calls.exc,
                           self._classes.mask(chunk.names)[calls.name]))

    def merge_from(self, other, code_map) -> None:
        self._merge_span(other)
        self._recs.extend(other._recs)

    def _metrics(self, ctx) -> EventFrame:
        nprocs = ctx.num_processes
        if not self._seen or nprocs <= 0 or self.num_windows <= 0:
            return _empty_efficiency()
        edges = _window_edges(self._t0, self._t1, self.num_windows)
        if self._recs:
            start, proc, exc, comm = (np.concatenate(c)
                                      for c in zip(*self._recs))
        else:
            start = proc = np.zeros(0, np.int64)
            exc, comm = np.zeros(0), np.zeros(0, bool)
        useful, comm_t = _accumulate_windows(edges, start, proc, exc, comm,
                                             nprocs)
        return _efficiency_frame(edges, useful, comm_t, nprocs)

    def result(self, ctx) -> EventFrame:
        return self._metrics(ctx)

    def fold_form(self):
        return _EfficiencyMetricsFold(self.num_windows, self.device)


@register_streaming("pop_efficiency")
class _PopEfficiencyAgg(_EfficiencyMetricsAgg):
    """Streaming :func:`pop_efficiency`: the metrics aggregator with the
    findings finalizer."""

    def __init__(self, threshold: float = 0.1, num_windows: int = 16,
                 device="cuda"):
        super().__init__(num_windows=num_windows, device=device)
        self.threshold = float(threshold)

    def result(self, ctx) -> EventFrame:
        return _pop_findings(self._metrics(ctx), self.threshold)

    def fold_form(self):
        return _PopEfficiencyFold(self.threshold, self.num_windows,
                                  self.device)


class _EfficiencyMetricsFold(StreamAgg):
    """:func:`efficiency_metrics` folded a chunk at a time on the host:
    window edges from the statistics pre-pass's span (the masked events'
    int64 ns, the span :class:`_SpanAgg` tracks), then each chunk's
    completed calls windowed by Enter timestamp and summed into float64
    ``[num_windows, processes]`` useful and communication ns, work units
    merged by a padded add.  Exact on integer-ns traces.  Mirrors the
    reference's streaming ``_EfficiencyMetricsAgg``."""

    needs_calls = True
    needs_stats = True
    supports_parallel = True

    def __init__(self, num_windows: int, device):
        self.num_windows = int(num_windows)
        self.device = device
        self._edges: Optional[np.ndarray] = None
        self._useful = np.zeros((max(self.num_windows, 1), 0))
        self._comm = np.zeros((max(self.num_windows, 1), 0))
        self._classes = _NameClassCache()

    def begin(self, stats) -> None:
        if stats.n_events and self.num_windows > 0:
            self._edges = _window_edges(int(stats.ts_min),
                                        int(stats.ts_max), self.num_windows)

    def update(self, chunk) -> None:
        calls = chunk.calls
        if self._edges is None or len(calls.proc) == 0:
            return
        useful, comm = _accumulate_windows(
            self._edges, np.asarray(calls.start, np.int64), calls.proc,
            np.nan_to_num(calls.exc),
            self._classes.mask(chunk.names)[calls.name],
            int(calls.proc.max()) + 1)
        self._useful = add_into(self._useful, useful)
        self._comm = add_into(self._comm, comm)

    def merge_from(self, other, code_map) -> None:
        self._useful = add_into(self._useful, other._useful)
        self._comm = add_into(self._comm, other._comm)

    def _metrics(self, ctx) -> EventFrame:
        nprocs = ctx.num_processes
        if self._edges is None or nprocs <= 0:
            return _empty_efficiency()
        from .ops_summary import _pad_to
        shape = (self.num_windows, nprocs)
        return _efficiency_frame(self._edges, _pad_to(self._useful, shape),
                                 _pad_to(self._comm, shape), nprocs)

    def result(self, ctx) -> EventFrame:
        return self._metrics(ctx)


class _PopEfficiencyFold(_EfficiencyMetricsFold):
    """:func:`pop_efficiency` folded: the metrics fold with the findings
    finalizer."""

    def __init__(self, threshold: float, num_windows: int, device):
        super().__init__(num_windows, device)
        self.threshold = threshold

    def result(self, ctx) -> EventFrame:
        return _pop_findings(self._metrics(ctx), self.threshold)


# ---------------------------------------------------------------------------
# diagnose: every detector, one combined ranked report
# ---------------------------------------------------------------------------

def _resolve_detectors(detectors) -> List[str]:
    if detectors is None:
        return list_detectors()
    names = [str(d) for d in detectors]
    for d in names:
        if d not in _DETECTOR_REGISTRY:
            raise ValueError(f"unknown detector {d!r}; registered: "
                             f"{list_detectors()}")
    return sorted(set(names))


def _rank_findings(frames: Sequence[EventFrame]) -> EventFrame:
    """Concatenate per-detector Findings into one ranked report (the
    total order :func:`Findings` uses)."""
    rows: List[dict] = []
    for fr in frames:
        for i in range(len(fr)):
            rows.append({c: fr[c][i] for c in FINDINGS_COLUMNS})
    return Findings(rows)


@register_op("diagnose", needs_structure=True, needs_messages=True)
def diagnose(trace, detectors: Optional[Sequence[str]] = None,
             device="cuda") -> EventFrame:
    """Run every registered detector (or a named subset) and return one
    combined, severity-ranked Findings frame.

    Each detector runs with its default arguments (on ``device``, if it
    takes one); tune an individual detector by calling its op directly
    (``trace.query().stragglers(threshold=0.1)``).

    Args:
        detectors: detector names to run (None = all registered).

    Returns:
        Findings frame over all selected detectors, ranked by severity
        descending — the ``detector`` column says which check fired.
    """
    names = _resolve_detectors(detectors)
    return _rank_findings([
        call_with_device(_DETECTOR_REGISTRY[d].fn, None, trace, device=device)
        for d in names])


@register_streaming("diagnose")
class _DiagnoseAgg(StreamAgg):
    """Composite aggregator: one child aggregator per selected detector,
    all fed from the same single pass over the stream (call stitching is
    shared).  Parallel-safe because every detector's child merges across
    work units."""

    needs_calls = True
    supports_parallel = True

    def __init__(self, detectors: Optional[Sequence[str]] = None,
                 device="cuda"):
        self._names = _resolve_detectors(detectors)
        self.device = device
        self._children: List[StreamAgg] = []
        for d in self._names:
            spec = get_op(d)
            if spec is None or spec.streaming is None:
                raise StreamingUnsupported(
                    f"detector {d!r} has no streaming form; materialize "
                    f"with .collect().diagnose(...) or run it eagerly")
            self._children.append(call_with_device(
                spec.streaming, spec.streaming_takes_device, device=device))

    def update(self, chunk) -> None:
        for c in self._children:
            c.update(chunk)

    def merge_from(self, other, code_map) -> None:
        for mine, theirs in zip(self._children, other._children):
            mine.merge_from(theirs, code_map)

    def result(self, ctx) -> EventFrame:
        return _rank_findings([c.result(ctx) for c in self._children])

    def fold_form(self):
        return _DiagnoseFold(self._names, self.device)


class _DiagnoseFold(StreamAgg):
    """``diagnose`` folded: each selected detector's ``fold="chunks"``
    form, all fed from one pass (the statistics pre-pass too, when a
    child needs it).  ``deferred`` is handed down to every child, so in a
    pool worker ``stragglers``' fold holds its parts and the parent
    launches ``seg_sum`` for them in :meth:`merge_from`, child by child.
    Mirrors the reference's streaming ``_DiagnoseAgg``."""

    needs_calls = True
    supports_parallel = True

    def __init__(self, names: Sequence[str], device):
        self._children = [make_agg(d, get_op(d).streaming, (),
                                   {"device": device}, "chunks")
                          for d in names]
        self.needs_stats = any(c.needs_stats for c in self._children)

    @property
    def deferred(self) -> bool:
        return any(getattr(c, "deferred", False) for c in self._children)

    @deferred.setter
    def deferred(self, value: bool) -> None:
        for c in self._children:
            if isinstance(c, FoldAgg):
                c.deferred = value

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self._children)

    def begin(self, stats) -> None:
        for c in self._children:
            c.begin(stats)

    def update(self, chunk) -> None:
        for c in self._children:
            c.update(chunk)

    def merge_from(self, other, code_map) -> None:
        for mine, theirs in zip(self._children, other._children):
            mine.merge_from(theirs, code_map)

    def result(self, ctx) -> EventFrame:
        return _rank_findings([c.result(ctx) for c in self._children])
