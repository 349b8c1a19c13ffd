"""Communication ops (paper §IV-C): ``comm_matrix`` and
``message_histogram`` on the card, and ``comm_by_process``,
``comm_over_time`` and ``comm_comp_breakdown`` on the host.

Mirrors :mod:`repro.core.ops_comm`.  The kernel paths
(``_comm_matrix_pallas``, ``_message_histogram_pallas``, with their
``_wrap_partners`` and ``_hist_indices`` rules): send records go through
the ``pair_sum`` kernel in canonical order, and exact host-computed bin
indices through the ``hist_bin`` kernel, on ``device`` — the card by
default, the kernels' plain versions with ``device="cpu"``.  Their
streaming forms (the reference's ``backend="pallas"`` branch of
``_CommMatrixAgg`` and ``_MessageHistogramAgg``) buffer the send records
and make the same one kernel call at the end; their ``fold="chunks"``
forms launch the kernel once a chunk into bounded state, the histogram on
edges from the statistics pre-pass's size range, as the reference's
``backend="numpy"`` forms do.

No kernel backs the other three ops, in the reference or here: they
compute in NumPy on the host whatever the ``device`` (which is still
checked, so asking for the card without one raises).  The streaming forms
of ``comm_by_process`` and ``comm_over_time`` buffer the send records too
and reduce them once in ``result()``, in the order the in-memory op uses,
so every route gives the in-memory op's bits.  Their ``fold="chunks"``
forms reduce each chunk with NumPy into per-process sums
(``comm_by_process``) or bins on the pre-pass's edges
(``comm_over_time``), as the reference's streaming forms do.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from . import accel
from .accel import resolve_device
from .constants import (DEFAULT_COMM_PREFIXES, ENTER, ET, MATCH, MPI_SEND,
                        MSG_SIZE, NAME, PARENT, PARTNER, PROC, TS)
from .frame import EventFrame
from .intervals import merge_intervals
from .registry import register_op, register_streaming
from .streaming import FoldAgg, StreamAgg, add_into, grow_to

__all__ = ["comm_matrix", "message_histogram", "comm_by_process",
           "comm_over_time", "comm_comp_breakdown", "comm_name_mask"]


def _sends(ev: EventFrame, output: str = "size"):
    """(sender, partner, weight, timestamp) of a frame's send instants, or
    None when it has none.  The weight is the message bytes (NaN as 0) for
    ``output="size"``, else 1."""
    if PARTNER not in ev:
        return None
    sel = ev.cat(NAME).mask_eq(MPI_SEND)
    if not sel.any():
        return None
    w = (np.nan_to_num(np.asarray(ev[MSG_SIZE], np.float64)[sel])
         if output == "size" else np.ones(int(sel.sum())))
    return (np.asarray(ev[PROC], np.int64)[sel],
            np.asarray(ev[PARTNER], np.int64)[sel], w,
            np.asarray(ev[TS], np.float64)[sel])


def _wrap_partners(src, dst, n: int, op: str):
    """Negative partner ids wrap like numpy fancy indexing (``-1`` is the
    last process); out-of-range ids raise the same IndexError the
    reference raises instead of silently dropping."""
    if len(dst) and (int(src.max()) >= n or int(dst.max()) >= n
                     or int(src.min()) < 0 or int(dst.min()) < -n):
        raise _range_error(op, n)
    return np.where(dst < 0, dst + n, dst)


def _matrix(sends, n: int, op: str, device) -> np.ndarray:
    """The ``pair_sum`` kernel over canonically ordered send records."""
    if sends is None or n == 0:
        return np.zeros((n, n))
    src, dst, w, ts = sends
    dst = _wrap_partners(src, dst, n, op)
    o = accel.canonical_order(ts, ts, src, dst, w)
    return accel.pair_sum(src[o], dst[o], w[o], n, n, device=device)


@register_op("comm_matrix", needs_messages=True)
def comm_matrix(trace, output: str = "size", device="cuda") -> np.ndarray:
    """Process-to-process communication matrix (§IV-C, Fig. 3): every send
    instant aggregated by (sender, receiver) in the ``pair_sum`` kernel.

    Args:
        output: ``"size"`` (default) sums message bytes; any other value
            counts messages.
        device: where the kernel runs (``"cuda"`` or ``"cpu"``).

    Returns:
        ``(nprocs, nprocs)`` float array; ``M[i, j]`` is the bytes (or
        number of messages) process i sent to process j.
    """
    return _matrix(_sends(trace.events, output), trace.num_processes,
                   "comm_matrix", device)


def _range_error(op: str, n: int) -> IndexError:
    return IndexError(f"{op}: message endpoints outside the selected "
                      f"trace's 0..{n - 1} process range")


def _hist_indices(sizes: np.ndarray, edges: np.ndarray,
                  bins: int) -> np.ndarray:
    """Exact ``np.histogram`` bin assignment: half-open bins with the last
    bin closed — ``searchsorted(side="right") - 1`` over the edge array,
    clipped so the top edge lands in the final bin."""
    return np.clip(np.searchsorted(edges, sizes, side="right") - 1,
                   0, bins - 1)


@register_op("message_histogram")
def message_histogram(trace, bins: int = 10, device="cuda"
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Distribution of message sizes (§IV-C, Fig. 4): exact host-side bin
    indices counted by the ``hist_bin`` kernel, so the counts equal
    ``np.histogram``'s.

    Returns:
        ``(counts, edges)`` à la ``np.histogram``.
    """
    s = _sends(trace.events)
    return _histogram(None if s is None else s[2], bins, device)


def _histogram(sizes, bins: int, device) -> Tuple[np.ndarray, np.ndarray]:
    """``np.histogram``'s edges over ``sizes`` and its counts by the
    ``hist_bin`` kernel."""
    if sizes is None:
        return np.zeros(bins, np.int64), np.linspace(0, 1, bins + 1)
    edges = np.histogram_bin_edges(sizes, bins=bins)
    return (accel.hist_counts(_hist_indices(sizes, edges, bins), bins,
                              device=device), edges)


# ---------------------------------------------------------------------------
# streaming forms: buffer the send records, one kernel call in result()
# ---------------------------------------------------------------------------

class _SendsAgg(StreamAgg):
    """Send records of every chunk, kept for one kernel call at the end; a
    later work unit's records merge in after this state's (they carry no
    name codes)."""

    supports_parallel = True

    def __init__(self, output: str, device):
        self.output = output
        self.device = device
        self._parts = []

    def update(self, chunk) -> None:
        s = _sends(chunk.events, self.output)
        if s is not None:
            self._parts.append(s)

    def merge_from(self, other, code_map) -> None:
        self._parts.extend(other._parts)

    def sends(self):
        """(sender, partner, weight, timestamp) over the stream, or None."""
        if not self._parts:
            return None
        return tuple(np.concatenate(c) for c in zip(*self._parts))


@register_streaming("comm_matrix")
class _CommMatrixAgg(_SendsAgg):
    """Streaming comm matrix: the in-memory op's one ``pair_sum`` call on
    the stream's send records."""

    def __init__(self, output: str = "size", device="cuda"):
        super().__init__(output, device)

    def result(self, ctx) -> np.ndarray:
        return _matrix(self.sends(), ctx.num_processes,
                       "streaming comm_matrix", self.device)

    def fold_form(self):
        return _CommMatrixFold(self.output, self.device)


@register_streaming("message_histogram")
class _MessageHistogramAgg(_SendsAgg):
    """Streaming message histogram: the in-memory op's edges and one
    ``hist_bin`` call over the stream's message sizes."""

    def __init__(self, bins: int = 10, device="cuda"):
        super().__init__("size", device)
        self.bins = bins

    def result(self, ctx) -> Tuple[np.ndarray, np.ndarray]:
        s = self.sends()
        return _histogram(None if s is None else s[2], self.bins,
                          self.device)

    def fold_form(self):
        return _MessageHistogramFold(self.bins, self.device)


class _CommMatrixFold(FoldAgg):
    """``comm_matrix`` folded a chunk at a time: one ``pair_sum`` launch a
    chunk into a float64 sender x partner matrix.  A negative partner
    wraps to ``n + partner`` as in memory, but ``n`` (the selected
    processes) is known only at the end: the launch puts partner ``-k`` in
    column ``m + k - 1`` past the chunk's ``m`` columns, and those columns
    are kept apart per sender and placed in ``result()``.  Mirrors the
    reference's ``_CommMatrixAgg`` with ``backend="numpy"``."""

    def __init__(self, output: str, device):
        super().__init__(device)
        self.output = output
        self._mat = np.zeros((0, 0))
        self._neg = np.zeros((0, 0))   # [sender, -partner - 1]
        self._extent = 0               # 1 + the largest endpoint
        self._neg_extent = 0           # the most negative partner, negated
        self._src_min = 0

    def records(self, chunk):
        s = _sends(chunk.events, self.output)
        return None if s is None else s[:3]

    def fold(self, part) -> None:
        src, dst, w = part
        neg = dst < 0
        m = int(max(src.max(), dst.max())) + 1
        k = int(-dst.min()) if neg.any() else 0
        col = np.where(neg, m - 1 - dst, dst)
        block = accel.pair_sum(src, col, w, m, m + k, device=self.device)
        self._src_min = min(self._src_min, int(src.min()))
        self._extent = max(self._extent, m)
        self._mat = add_into(self._mat, block[:, :m])
        if k:
            self._neg_extent = max(self._neg_extent, k)
            self._neg = add_into(self._neg, block[:, m:])

    def result(self, ctx) -> np.ndarray:
        n = ctx.num_processes
        if n == 0:
            return np.zeros((0, 0))
        if self._src_min < 0 or max(self._extent, self._neg_extent) > n:
            raise _range_error("streaming comm_matrix", n)
        out = np.zeros((n, n))
        e = self._extent
        out[:e, :e] = self._mat[:e, :e]
        a = min(e, self._neg.shape[0])
        for j in range(self._neg_extent):  # partner -(j + 1): column n-j-1
            out[:a, n - j - 1] += self._neg[:a, j]
        return out


class _MessageHistogramFold(FoldAgg):
    """``message_histogram`` folded a chunk at a time on edges the
    statistics pre-pass fixes from the stream's size range
    (``np.histogram_bin_edges`` over ``[size_min, size_max]``, the edges
    the in-memory op derives): per chunk, exact host bin indices counted
    by one ``hist_bin`` launch, added into int64 counts.  Mirrors the
    reference's ``_MessageHistogramAgg`` with ``backend="numpy"``."""

    needs_stats = True

    def __init__(self, bins: int, device):
        super().__init__(device)
        self.bins = bins
        self._edges: Optional[np.ndarray] = None
        self._counts = np.zeros(bins, np.int64)

    def begin(self, stats) -> None:
        if stats.n_sends:
            self._edges = np.histogram_bin_edges(
                np.asarray([stats.size_min, stats.size_max]), bins=self.bins,
                range=(stats.size_min, stats.size_max))

    def records(self, chunk):
        s = _sends(chunk.events)
        return None if s is None else (s[2],)

    def fold(self, part) -> None:
        (sizes,) = part
        self._counts += accel.hist_counts(
            _hist_indices(sizes, self._edges, self.bins), self.bins,
            device=self.device)

    def result(self, ctx) -> Tuple[np.ndarray, np.ndarray]:
        if self._edges is None or not self.folds:
            return np.zeros(self.bins, np.int64), np.linspace(0, 1,
                                                              self.bins + 1)
        return self._counts.copy(), self._edges


# ---------------------------------------------------------------------------
# host ops: per-process volume, traffic over time, comm/comp overlap
# ---------------------------------------------------------------------------

def _send_order(sends):
    """The send records in one fixed order — sender, timestamp, partner,
    weight: the row order of a trace kept in (process, time) order — so
    that a route that gathers them in another order (chunks, work units)
    reduces them as the in-memory op does."""
    src, dst, w, ts = sends
    o = np.lexsort((w, dst, ts, src))
    return src[o], dst[o], w[o], ts[o]


def _by_process(sends, n: int) -> EventFrame:
    """Sent and received volume per process over ``n`` processes: one
    ``np.add.at`` each, so a partner of -1 wraps to the last process and
    one at or beyond ``n`` raises IndexError, as in the reference."""
    sent = np.zeros(n)
    recv = np.zeros(n)
    if sends is not None:
        src, dst, w, _ts = _send_order(sends)
        np.add.at(sent, src, w)
        np.add.at(recv, dst, w)
    return EventFrame({PROC: np.arange(n, dtype=np.int32), "sent": sent,
                       "received": recv, "total": sent + recv})


@register_op("comm_by_process")
def comm_by_process(trace, output: str = "size", device="cuda"
                    ) -> EventFrame:
    """Total communication volume per process (§IV-C).

    Args:
        output: ``"size"`` (default) sums bytes; anything else counts
            messages.
        device: the op's device (host NumPy either way).

    Returns:
        EventFrame with one row per process: ``Process``, ``sent``,
        ``received``, and ``total`` (sent + received), in bytes or message
        counts.
    """
    resolve_device(device)
    return _by_process(_sends(trace.events, output), trace.num_processes)


def _over_time(sends, t0: float, t1: float, num_bins: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Send weights binned by timestamp over ``num_bins`` equal bins of
    ``[t0, max(t1, t0 + 1)]``."""
    edges = np.linspace(t0, max(t1, t0 + 1), num_bins + 1)
    if sends is None:
        return np.zeros(num_bins), edges
    _src, _dst, w, ts = _send_order(sends)
    vals, _ = np.histogram(ts, bins=edges, weights=w)
    return vals, edges


@register_op("comm_over_time")
def comm_over_time(trace, num_bins: int = 32, output: str = "size",
                   device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Message traffic over time (§IV-C): sends binned by timestamp.

    Args:
        num_bins: equal-width time bins over the whole trace span.
        output: ``"size"`` (default) sums bytes per bin; anything else
            counts messages per bin.
        device: the op's device (host NumPy either way).

    Returns:
        ``(values, edges)``: ``values`` has ``num_bins`` totals, ``edges``
        has ``num_bins + 1`` bin boundaries in ns.
    """
    resolve_device(device)
    ev = trace.events
    ts = np.asarray(ev[TS], np.float64)
    t0 = float(ts.min()) if len(ev) else 0.0
    t1 = float(ts.max()) if len(ev) else 1.0
    return _over_time(_sends(ev, output), t0, t1, num_bins)


def _check_partner_range(extent: int, n: int, op: str) -> None:
    """A stream sizes its output by the selected processes; a partner id
    at or beyond them (``extent`` is 1 + the largest) would fail the
    in-memory op too, so say why instead of letting NumPy's bare
    IndexError stand (e.g. ``restrict_processes([0])`` then
    ``comm_by_process()``)."""
    if extent > n:
        raise IndexError(
            f"streaming {op}: message partner ids reach process "
            f"{extent - 1} but the selected stream only contains processes "
            f"0..{n - 1}; widen the process restriction to cover message "
            f"partners (the in-memory path fails on this selection too)")


@register_streaming("comm_by_process")
class _CommByProcessAgg(_SendsAgg):
    """Streaming per-process volume: the stream's send records reduced
    once, as the in-memory op reduces them."""

    def __init__(self, output: str = "size", device="cuda"):
        resolve_device(device)
        super().__init__(output, device)

    def result(self, ctx) -> EventFrame:
        n = ctx.num_processes
        sends = self.sends()
        if sends is not None and len(sends[1]):
            _check_partner_range(int(sends[1].max()) + 1, n,
                                 "comm_by_process")
        return _by_process(sends, n)

    def fold_form(self):
        return _CommByProcessFold(self.output, self.device)


class _CommByProcessFold(StreamAgg):
    """``comm_by_process`` folded a chunk at a time on the host (no kernel
    backs it): per-process float64 ``sent`` and ``received`` added with
    ``np.add.at``, work units merged by a padded add.  A negative partner
    wraps to ``n + partner`` as the eager op's ``np.add.at`` wraps it
    (not as the reference's stream, which credits every negative partner
    to the last rank: ROADMAP §C), but ``n`` is known only at the end, so
    its weight is parked by the partner's value and added in ``result``.
    Exact on integer sizes; elsewhere within ``launch/cardcheck.gate`` of
    the eager op, which sums in its own record order.  Mirrors the
    reference's streaming ``_CommByProcessAgg``."""

    supports_parallel = True

    def __init__(self, output: str, device):
        self.output = output
        self.device = device
        self._sent = np.zeros(0)
        self._recv = np.zeros(0)
        self._neg = np.zeros(0)   # [-partner - 1]: weight sent to partner
        self._extent = 0          # 1 + the largest partner

    def update(self, chunk) -> None:
        s = _sends(chunk.events, self.output)
        if s is None:
            return
        src, dst, w, _ts = s
        self._sent = grow_to(self._sent, (int(src.max()) + 1,))
        np.add.at(self._sent, src, w)
        neg = dst < 0
        if neg.any():
            k = -dst[neg] - 1
            self._neg = grow_to(self._neg, (int(k.max()) + 1,))
            np.add.at(self._neg, k, w[neg])
        if not neg.all():
            self._extent = max(self._extent, int(dst[~neg].max()) + 1)
            self._recv = grow_to(self._recv, (self._extent,))
            np.add.at(self._recv, dst[~neg], w[~neg])

    def merge_from(self, other, code_map) -> None:
        self._sent = add_into(self._sent, other._sent)
        self._recv = add_into(self._recv, other._recv)
        self._neg = add_into(self._neg, other._neg)
        self._extent = max(self._extent, other._extent)

    def result(self, ctx) -> EventFrame:
        n = ctx.num_processes
        _check_partner_range(self._extent, n, "comm_by_process")
        if len(self._neg) > n:
            raise _range_error("streaming comm_by_process", n)
        sent = np.zeros(n)
        recv = np.zeros(n)
        sent[:min(n, len(self._sent))] = self._sent[:n]
        recv[:min(n, len(self._recv))] = self._recv[:n]
        for j in range(len(self._neg)):  # partner -(j + 1): rank n - j - 1
            recv[n - j - 1] += self._neg[j]
        return EventFrame({PROC: np.arange(n, dtype=np.int32), "sent": sent,
                           "received": recv, "total": sent + recv})


@register_streaming("comm_over_time")
class _CommOverTimeAgg(_SendsAgg):
    """Streaming traffic over time: the masked stream's time span (over
    every event, as the in-memory op's edges) tracked per chunk, the send
    records binned once at the end."""

    def __init__(self, num_bins: int = 32, output: str = "size",
                 device="cuda"):
        resolve_device(device)
        super().__init__(output, device)
        self.num_bins = num_bins
        self._t0, self._t1 = np.inf, -np.inf

    def update(self, chunk) -> None:
        ts = np.asarray(chunk.events[TS], np.float64)
        if len(ts):
            self._t0 = min(self._t0, float(ts.min()))
            self._t1 = max(self._t1, float(ts.max()))
        super().update(chunk)

    def merge_from(self, other, code_map) -> None:
        self._t0 = min(self._t0, other._t0)
        self._t1 = max(self._t1, other._t1)
        super().merge_from(other, code_map)

    def result(self, ctx) -> Tuple[np.ndarray, np.ndarray]:
        if self._t0 > self._t1:
            return _over_time(None, 0.0, 1.0, self.num_bins)
        return _over_time(self.sends(), self._t0, self._t1, self.num_bins)

    def fold_form(self):
        return _CommOverTimeFold(self.num_bins, self.output, self.device)


class _CommOverTimeFold(StreamAgg):
    """``comm_over_time`` folded a chunk at a time: the pre-pass's time
    span (over every event, the in-memory op's) fixes the edges, and each
    chunk's sends are binned with ``np.histogram`` into float64 totals, on
    the host (no kernel backs this op), in a pool worker too.  Mirrors the
    reference's streaming ``_CommOverTimeAgg``."""

    needs_stats = True
    supports_parallel = True

    def __init__(self, num_bins: int, output: str, device):
        self.num_bins = num_bins
        self.output = output
        self.device = device
        self._vals = np.zeros(num_bins)
        self._edges = np.linspace(0.0, 1.0, num_bins + 1)

    def begin(self, stats) -> None:
        t0 = stats.ts_min if stats.n_events else 0.0
        t1 = stats.ts_max if stats.n_events else 1.0
        self._edges = np.linspace(t0, max(t1, t0 + 1), self.num_bins + 1)

    def update(self, chunk) -> None:
        s = _sends(chunk.events, self.output)
        if s is not None:
            self._vals += np.histogram(s[3], bins=self._edges,
                                       weights=s[2])[0]

    def merge_from(self, other, code_map) -> None:
        self._vals += other._vals

    def result(self, ctx) -> Tuple[np.ndarray, np.ndarray]:
        return self._vals.copy(), self._edges


def comm_name_mask(events: EventFrame,
                   prefixes: Sequence[str] = DEFAULT_COMM_PREFIXES
                   ) -> np.ndarray:
    """Per-row boolean mask: True where the event's function name looks
    like communication (a comm prefix, or a collective / NCCL / send /
    recv substring)."""
    cat = events.cat(NAME)
    subs = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
            "collective-permute", "nccl", "send", "recv")
    is_comm_cat = np.zeros(len(cat.categories), dtype=bool)
    for i, c in enumerate(cat.categories):
        cs = str(c)
        low = cs.lower()
        is_comm_cat[i] = (cs.startswith(tuple(prefixes))
                          or any(x in low for x in subs))
    return is_comm_cat[cat.codes]


@register_op("comm_comp_breakdown", needs_structure=True)
def comm_comp_breakdown(trace,
                        comm_matcher: Optional[Callable[[str], bool]] = None,
                        device="cuda") -> EventFrame:
    """Per-process split of wall time into non-overlapped computation,
    computation overlapped with communication, non-overlapped
    communication, and other/idle (§IV-C, Fig. 13).

    Communication and computation overlap only across threads/streams of
    one process (a compute stream beside an NCCL stream); interval algebra
    over the merged per-class interval sets gives the split.  Leaf calls
    count as computation unless they are communication; every
    communication call counts, leaf or not (an ``MPI_Wait`` around its
    ``Isend``).

    Args:
        comm_matcher: ``fn(name) -> bool`` deciding which functions count
            as communication; default :func:`comm_name_mask`.  A callable
            cannot travel to the trace-query service.
        device: the op's device (host NumPy either way).

    Returns:
        EventFrame with one row per process: ``Process``, ``comp_only``,
        ``overlap``, ``comm_only``, ``other`` (unaccounted/idle), and
        ``span`` (the process's wall-clock extent) — all in ns, with
        ``comp_only + overlap + comm_only + other == span``.
    """
    resolve_device(device)
    ev = trace.events
    n = len(ev)
    procs = np.asarray(ev[PROC], np.int64)
    ts = np.asarray(ev[TS], np.float64)
    match = np.asarray(ev.column(MATCH), np.int64)
    is_enter = ev.cat(ET).mask_eq(ENTER)

    if comm_matcher is None:
        comm_mask = comm_name_mask(ev)
    else:
        cat = ev.cat(NAME)
        per_cat = np.asarray([bool(comm_matcher(str(c)))
                              for c in cat.categories], dtype=bool)
        comm_mask = per_cat[cat.codes]

    parent = np.asarray(ev.column(PARENT), np.int64)
    has_child = np.zeros(n, dtype=bool)
    pe = parent[(parent >= 0) & is_enter]
    has_child[pe[pe >= 0]] = True

    sel = np.nonzero(is_enter & (match >= 0))[0]
    leaf = sel[~has_child[sel]]
    comp_leaf = leaf[~comm_mask[leaf]]
    comm_any = sel[comm_mask[sel]]

    nprocs = trace.num_processes
    cols = {k: np.zeros(nprocs) for k in
            ("comp_only", "overlap", "comm_only", "other", "span")}
    for p in range(nprocs):
        def spans(rows):
            rows = rows[procs[rows] == p]
            return merge_intervals(ts[rows], ts[match[rows]])
        comm_iv = spans(comm_any)
        comp_iv = spans(comp_leaf)
        p_rows = np.nonzero(procs == p)[0]
        if len(p_rows) == 0:
            continue
        span = float(ts[p_rows].max() - ts[p_rows].min())
        lcomm = float(np.sum(comm_iv[1] - comm_iv[0]))
        lcomp = float(np.sum(comp_iv[1] - comp_iv[0]))
        us, ue = merge_intervals(np.concatenate([comm_iv[0], comp_iv[0]]),
                                 np.concatenate([comm_iv[1], comp_iv[1]]))
        lunion = float(np.sum(ue - us))
        ov = lcomm + lcomp - lunion
        cols["overlap"][p] = ov
        cols["comm_only"][p] = lcomm - ov
        cols["comp_only"][p] = lcomp - ov
        cols["other"][p] = max(span - lunion, 0.0)
        cols["span"][p] = span
    out = EventFrame({PROC: np.arange(nprocs, dtype=np.int32)})
    for k, v in cols.items():
        out[k] = v
    return out
