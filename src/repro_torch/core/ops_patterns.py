"""Pattern detection via matrix profiles (paper §IV-D, Fig. 8).

STUMPY is unavailable offline, so we implement the underlying algorithms
directly: MASS (Mueen's Algorithm for Similarity Search — z-normalized
sliding-window distances via FFT convolution) and the STOMP-style matrix
profile built from it.  The public entry point, :func:`detect_pattern`,
reproduces the paper's workflow: given a ``start_event`` hint it finds the
repeating occurrences of that event, validates the period with the matrix
profile of the binned-activity series, and returns one EventFrame per
detected occurrence (time-windowed slices of the trace).

Mirrors :mod:`repro.core.ops_patterns`.  No kernel backs these ops, in the
reference or here: they run in NumPy on the host whatever the ``device``
(which is still checked, so asking for the card without one raises), and
need the whole trace at once, so they have no streaming form.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .accel import resolve_device
from .constants import ENTER, ET, EXC, NAME, PROC, TS
from .frame import EventFrame
from .registry import register_op

__all__ = ["mass", "matrix_profile", "activity_series", "detect_pattern"]


def _sliding_stats(series: np.ndarray, m: int) -> Tuple[np.ndarray, np.ndarray]:
    """Mean/std of every length-m window, via cumulative sums (O(n))."""
    s = np.concatenate([[0.0], np.cumsum(series)])
    s2 = np.concatenate([[0.0], np.cumsum(series.astype(np.float64) ** 2)])
    n = len(series) - m + 1
    mu = (s[m:] - s[:-m]) / m
    var = (s2[m:] - s2[:-m]) / m - mu**2
    return mu, np.sqrt(np.maximum(var, 1e-20))


def mass(query: np.ndarray, series: np.ndarray) -> np.ndarray:
    """Z-normalized Euclidean distance of ``query`` to every window of
    ``series`` (MASS): one FFT-based correlation + O(1) per-window algebra."""
    q = np.asarray(query, np.float64)
    t = np.asarray(series, np.float64)
    m, n = len(q), len(t)
    if n < m:
        return np.asarray([])
    qm, qs = q.mean(), max(q.std(), 1e-10)
    qz = (q - qm) / qs
    # correlation of t with reversed qz via FFT
    size = 1 << int(np.ceil(np.log2(n + m)))
    fq = np.fft.rfft(qz[::-1], size)
    ft = np.fft.rfft(t, size)
    corr = np.fft.irfft(fq * ft, size)[m - 1 : n]
    mu, sd = _sliding_stats(t, m)
    # z-normalized dot product: (corr - m*mu*mean(qz)) / sd ; mean(qz)=0
    dot = corr / np.maximum(sd, 1e-10)
    d2 = np.maximum(2.0 * (m - dot), 0.0)
    return np.sqrt(d2)


def matrix_profile(series: np.ndarray, m: int, exclusion: Optional[int] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Self-join matrix profile: for each window, distance to its nearest
    non-trivial neighbour.  STOMP-style loop over windows using MASS rows.

    Returns ``(profile, profile_index)``.
    """
    t = np.asarray(series, np.float64)
    n = len(t) - m + 1
    if n <= 1:
        return np.zeros(max(n, 0)), np.zeros(max(n, 0), np.int64)
    excl = exclusion if exclusion is not None else max(1, m // 2)
    prof = np.full(n, np.inf)
    pidx = np.zeros(n, np.int64)
    for i in range(n):
        d = mass(t[i : i + m], t)
        lo, hi = max(0, i - excl), min(n, i + excl + 1)
        d[lo:hi] = np.inf
        j = int(np.argmin(d))
        prof[i] = d[j]
        pidx[i] = j
    return prof, pidx


@register_op("activity_series", needs_structure=True)
def activity_series(trace, num_bins: int = 512, process: Optional[int] = None,
                    device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Binned total exclusive time (all functions) — the time-series signal
    pattern detection runs on.

    Args:
        num_bins: equal-width time bins over the trace span.
        process: restrict to one process id (None = all processes).

    Returns:
        ``(series, bin_edges)``: ``series`` has ``num_bins`` summed
        ``time.exc`` values (ns per bin, attributed to each call's Enter
        timestamp), ``bin_edges`` has ``num_bins + 1`` ns boundaries.
    """
    resolve_device(device)
    ev = trace.events
    trace._ensure_structure()
    ts = np.asarray(ev[TS], np.float64)
    sel = ev.cat(ET).mask_eq(ENTER)
    if process is not None:
        sel &= np.asarray(ev[PROC], np.int64) == process
    rows = np.nonzero(sel)[0]
    w = np.nan_to_num(np.asarray(ev.column(EXC), np.float64)[rows])
    t0, t1 = float(ts.min()), float(ts.max())
    edges = np.linspace(t0, max(t1, t0 + 1), num_bins + 1)
    series, _ = np.histogram(ts[rows], bins=edges, weights=w)
    return series, edges


@register_op("detect_pattern", needs_structure=True)
def detect_pattern(trace, start_event: Optional[str] = None, num_bins: int = 512,
                   process: int = 0, max_patterns: int = 64,
                   min_similarity: float = 0.8,
                   device="cuda") -> List[EventFrame]:
    """Find repeating program phases (§IV-D, Fig. 8 — iteration detection).

    If ``start_event`` is given, occurrences of that function delimit
    candidate iterations; the matrix profile of the binned activity series
    confirms which candidates are genuinely similar.  Without a hint, the
    motif period is inferred from the matrix profile's best motif pair.

    Args:
        start_event: function name whose Enter events delimit candidate
            iterations (e.g. the paper's ``"time-loop"``); None infers the
            period automatically.
        num_bins: resolution of the activity series the similarity check
            runs on.
        process: process id whose timeline anchors the candidates.
        max_patterns: stop after this many accepted occurrences.
        min_similarity: z-normalized correlation (−1..1) a candidate must
            reach against the first occurrence's signal to be kept.

    Returns:
        List of EventFrames, one per detected occurrence — each a
        time-windowed slice of ``trace.events`` (all processes included).
        Empty list when no repetition is found.
    """
    ev = trace.events
    trace._ensure_structure()
    ts = np.asarray(ev[TS], np.float64)
    series, edges = activity_series(trace, num_bins=num_bins, process=process,
                                    device=device)
    bw = edges[1] - edges[0]

    if start_event is not None:
        name = ev.cat(NAME)
        sel = (name.mask_eq(start_event) & ev.cat(ET).mask_eq(ENTER)
               & (np.asarray(ev[PROC], np.int64) == process))
        starts = np.sort(ts[np.nonzero(sel)[0]])
        if len(starts) < 2:
            return []
        bounds = np.concatenate([starts, [ts.max()]])
    else:
        # infer period: motif = argmin of matrix profile, period = |i - j|
        m = max(4, num_bins // 16)
        prof, pidx = matrix_profile(series, m)
        i = int(np.argmin(prof))
        period = abs(int(pidx[i]) - i)
        if period == 0:
            return []
        first = i % period
        k = (num_bins - first) // period
        bounds = edges[0] + bw * (first + period * np.arange(k + 1))

    # validate candidate windows against the first occurrence's signal
    out: List[EventFrame] = []
    ref_sig = None
    for a, b in zip(bounds[:-1], bounds[1:]):
        if len(out) >= max_patterns:
            break
        lo = int(np.clip((a - edges[0]) / bw, 0, num_bins - 1))
        hi = int(np.clip((b - edges[0]) / bw, lo + 1, num_bins))
        sig = series[lo:hi]
        if ref_sig is None:
            ref_sig = sig
        else:
            L = min(len(sig), len(ref_sig))
            if L >= 2:
                x = (sig[:L] - sig[:L].mean()) / max(sig[:L].std(), 1e-10)
                y = (ref_sig[:L] - ref_sig[:L].mean()) / max(ref_sig[:L].std(), 1e-10)
                if float(np.mean(x * y)) < min_similarity:
                    continue
        window = (ts >= a) & (ts < b)
        out.append(ev.mask(window))
    return out
