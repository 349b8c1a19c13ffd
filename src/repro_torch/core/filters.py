"""Composable Filter DSL (paper §IV-E).

    f = Filter("Name", "in", ["MPI_Send", "MPI_Recv"]) & Filter("Process", "<", 8)
    small = trace.filter(f)

Operators: ==, !=, <, <=, >, >=, in, not-in, between.  Filters compose with
``&``, ``|``, ``~``.  Time-range filters keep events whose *call interval*
overlaps the window when ``trim="overlap"`` (default for "between" on the
timestamp column), or strictly inside with ``trim="within"``.

A copy of :mod:`repro.core.filters` (the port imports nothing of the JAX
package): filters are host-side row predicates over the NumPy event frame.
"""

from __future__ import annotations

from typing import Any, Optional, Set, Tuple

import numpy as np

from .constants import PROC, TS
from .frame import Categorical, EventFrame

_OPS = ("==", "!=", "<", "<=", ">", ">=", "in", "not-in", "between")

# inclusive [lo, hi] bound on an integer column; None = unconstrained
Bounds = Optional[Tuple[float, float]]


class Filter:
    def __init__(self, field: str = None, operator: str = None, value: Any = None):
        if operator is not None and operator not in _OPS:
            raise ValueError(f"operator must be one of {_OPS}, got {operator!r}")
        self.field, self.operator, self.value = field, operator, value

    # -- composition -------------------------------------------------------
    def __and__(self, other: "Filter") -> "Filter":
        return _And(self, other)

    def __or__(self, other: "Filter") -> "Filter":
        return _Or(self, other)

    def __invert__(self) -> "Filter":
        return _Not(self)

    # -- introspection (used by the query planner) -------------------------
    def columns(self) -> Set[str]:
        """Column names this filter reads — lets the planner decide whether a
        selection can touch derived structure columns."""
        return {self.field} if self.field is not None else set()

    def process_bounds(self) -> Bounds:
        """Inclusive [lo, hi] bound on the Process values that can pass, or
        None when unconstrained.  Conservative: anything this filter cannot
        prove stays None.  The parallel reader uses it to skip whole shards
        before parsing (predicate pushdown, paper §VI)."""
        if self.field != PROC:
            return None
        op, val = self.operator, self.value
        try:
            if op == "==":
                v = float(val)
                return (v, v)
            if op == "in":
                vs = [float(v) for v in val]
                return (min(vs), max(vs)) if vs else (1.0, 0.0)
            if op == "between":
                lo, hi = val
                return (float(lo), float(hi))
            if op == "<":
                v = float(val)
                # process ids are integers: the largest passing id
                return (-np.inf, v - 1 if v.is_integer() else np.floor(v))
            if op == "<=":
                return (-np.inf, float(val))
            if op == ">":
                v = float(val)
                return (v + 1 if v.is_integer() else np.ceil(v), np.inf)
            if op == ">=":
                return (float(val), np.inf)
        except (TypeError, ValueError):
            return None
        return None  # !=, not-in: exclusions don't bound the domain

    @property
    def trim(self) -> Optional[str]:
        """Trim semantics for time-window filters (see time_window_filter):
        "overlap" keeps events whose whole call interval overlaps the window
        (needs matching columns), "within" keeps events whose own timestamp
        falls inside.  None for non-window filters."""
        t = getattr(self, "_trim", None)
        if t is not None and self.operator == "between" and self.field == TS:
            return t
        return None

    def window(self) -> Optional[Tuple[float, float]]:
        """(start, end) when this is a time-window filter, else None."""
        if self.operator == "between" and self.field == TS:
            lo, hi = self.value
            return float(lo), float(hi)
        return None

    # -- evaluation --------------------------------------------------------
    def mask(self, events: EventFrame) -> np.ndarray:
        col = events.column(self.field)
        op, val = self.operator, self.value
        if isinstance(col, Categorical):
            if op == "==":
                return col.mask_eq(str(val))
            if op == "!=":
                return ~col.mask_eq(str(val))
            if op == "in":
                return col.mask_isin([str(v) for v in val])
            if op == "not-in":
                return ~col.mask_isin([str(v) for v in val])
            col = col.to_strings()
        arr = np.asarray(col)
        if op == "==":
            return arr == val
        if op == "!=":
            return arr != val
        if op == "<":
            return arr < val
        if op == "<=":
            return arr <= val
        if op == ">":
            return arr > val
        if op == ">=":
            return arr >= val
        if op == "in":
            return np.isin(arr, np.asarray(list(val)))
        if op == "not-in":
            return ~np.isin(arr, np.asarray(list(val)))
        if op == "between":
            lo, hi = val
            return (arr >= lo) & (arr <= hi)
        raise ValueError(op)

    def __repr__(self) -> str:
        return f"Filter({self.field!r} {self.operator} {self.value!r})"


class _And(Filter):
    def __init__(self, a, b):
        super().__init__()
        self.a, self.b = a, b

    def mask(self, events):
        return self.a.mask(events) & self.b.mask(events)

    def columns(self):
        return self.a.columns() | self.b.columns()

    def process_bounds(self):
        ba, bb = self.a.process_bounds(), self.b.process_bounds()
        if ba is None:
            return bb
        if bb is None:
            return ba
        return (max(ba[0], bb[0]), min(ba[1], bb[1]))

    def __repr__(self):
        return f"({self.a!r} & {self.b!r})"


class _Or(Filter):
    def __init__(self, a, b):
        super().__init__()
        self.a, self.b = a, b

    def mask(self, events):
        return self.a.mask(events) | self.b.mask(events)

    def columns(self):
        return self.a.columns() | self.b.columns()

    def process_bounds(self):
        ba, bb = self.a.process_bounds(), self.b.process_bounds()
        if ba is None or bb is None:
            return None
        return (min(ba[0], bb[0]), max(ba[1], bb[1]))

    def __repr__(self):
        return f"({self.a!r} | {self.b!r})"


class _Not(Filter):
    def __init__(self, a):
        super().__init__()
        self.a = a

    def mask(self, events):
        return ~self.a.mask(events)

    def columns(self):
        return self.a.columns()

    def process_bounds(self):
        return None  # complement of a bound is unbounded

    def __repr__(self):
        return f"~{self.a!r}"


def time_window_filter(start: float, end: float, trim: str = "overlap") -> Filter:
    """Convenience: filter to a time window.

    ``trim="overlap"`` (default) keeps every event whose *call interval*
    overlaps [start, end] — Trace.filter and the query planner materialize
    enter/leave matching to extend the window per matched pair, exactly like
    ``Trace.slice_time``.  ``trim="within"`` keeps only events whose own
    timestamp falls inside the window.
    """
    if trim not in ("overlap", "within"):
        raise ValueError(f'trim must be "overlap" or "within", got {trim!r}')
    f = Filter(TS, "between", (start, end))
    f._trim = trim
    return f
