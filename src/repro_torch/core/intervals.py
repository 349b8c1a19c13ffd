"""Vectorized interval algebra used by comm/comp overlap and idle analyses.

A copy of :mod:`repro.core.intervals` (host NumPy): the port keeps its
own so that it imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def merge_intervals(starts: np.ndarray, ends: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Union of possibly-overlapping intervals, as disjoint sorted intervals."""
    if len(starts) == 0:
        return starts[:0].astype(np.float64), ends[:0].astype(np.float64)
    order = np.argsort(starts, kind="stable")
    s = np.asarray(starts, np.float64)[order]
    e = np.asarray(ends, np.float64)[order]
    e = np.maximum.accumulate(e)
    # a new merged interval starts where s[i] > running max end of previous
    new = np.ones(len(s), dtype=bool)
    new[1:] = s[1:] > e[:-1]
    grp = np.cumsum(new) - 1
    out_s = s[new]
    out_e = np.zeros(len(out_s))
    np.maximum.at(out_e, grp, e)
    return out_s, out_e


def total_length(starts: np.ndarray, ends: np.ndarray) -> float:
    s, e = merge_intervals(starts, ends)
    return float(np.sum(e - s))


def intersect_length(a: Tuple[np.ndarray, np.ndarray], b: Tuple[np.ndarray, np.ndarray]) -> float:
    """|A ∩ B| = |A| + |B| − |A ∪ B| for merged interval sets."""
    la = float(np.sum(a[1] - a[0]))
    lb = float(np.sum(b[1] - b[0]))
    us, ue = merge_intervals(np.concatenate([a[0], b[0]]), np.concatenate([a[1], b[1]]))
    return la + lb - float(np.sum(ue - us))


def subtract_length(a: Tuple[np.ndarray, np.ndarray], b: Tuple[np.ndarray, np.ndarray]) -> float:
    """|A \\ B| for merged interval sets."""
    la = float(np.sum(a[1] - a[0]))
    return la - intersect_length(a, b)
