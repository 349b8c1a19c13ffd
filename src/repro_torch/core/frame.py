"""Columnar event store — the pandas-DataFrame analogue Pipit is built on.

A copy of :mod:`repro.core.frame` (the port imports nothing of the JAX
package).  Frames stay on the host in NumPy; the analysis ops move the
record columns they reduce onto the device.

The paper (§III-A) argues that storing each event attribute as a contiguous
column lets trace analysis vectorize.  pandas is not available in this
environment, so ``EventFrame`` implements that insight directly on NumPy:

* every column is a single contiguous ``np.ndarray`` (column-major layout),
* string-valued columns (``Name``, ``Event Type``) are dictionary-encoded as
  ``Categorical`` (int32 codes + a small category table), matching pandas'
  categorical dtype that Pipit relies on for memory/performance,
* row selection (boolean mask / index take) is zero-copy per column where
  NumPy allows it, and ``groupby_agg`` is vectorized NumPy
  (``np.lexsort`` + ``np.add.reduceat``), as in the reference; the
  analysis ops reduce on the device instead.
"""

from __future__ import annotations

import io
from typing import (Any, Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Union)

import numpy as np

__all__ = ["Categorical", "EventFrame", "concat", "optimize_dtypes"]


class Categorical:
    """Dictionary-encoded string column: int32 codes into a category table."""

    __slots__ = ("codes", "categories", "_lookup")

    def __init__(self, codes: np.ndarray, categories: np.ndarray):
        self.codes = np.asarray(codes, dtype=np.int32)
        self.categories = np.asarray(categories)
        self._lookup: Optional[Dict[str, int]] = None

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_values(cls, values: Iterable[Any]) -> "Categorical":
        arr = np.asarray(list(values) if not isinstance(values, np.ndarray) else values)
        if arr.dtype.kind in ("U", "S", "O"):
            cats, codes = np.unique(arr.astype(str), return_inverse=True)
            return cls(codes.astype(np.int32), cats)
        raise TypeError(f"Categorical.from_values expects strings, got {arr.dtype}")

    @classmethod
    def from_codes(cls, codes: np.ndarray, categories: Sequence[str]) -> "Categorical":
        return cls(np.asarray(codes, np.int32), np.asarray(categories, dtype=object).astype(str))

    # -- core --------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.codes)

    def to_strings(self) -> np.ndarray:
        return self.categories[self.codes]

    def lookup(self, name: str) -> int:
        """Code of ``name`` or -1 if absent."""
        if self._lookup is None:
            self._lookup = {str(c): i for i, c in enumerate(self.categories)}
        return self._lookup.get(name, -1)

    def mask_eq(self, name: str) -> np.ndarray:
        c = self.lookup(name)
        if c < 0:
            return np.zeros(len(self.codes), dtype=bool)
        return self.codes == c

    def mask_isin(self, names: Iterable[str]) -> np.ndarray:
        codes = [self.lookup(n) for n in names]
        codes = [c for c in codes if c >= 0]
        if not codes:
            return np.zeros(len(self.codes), dtype=bool)
        return np.isin(self.codes, np.asarray(codes, np.int32))

    def take(self, idx: np.ndarray) -> "Categorical":
        return Categorical(self.codes[idx], self.categories)

    def append(self, other: "Categorical") -> "Categorical":
        if len(self.categories) == len(other.categories) and np.array_equal(
            self.categories, other.categories
        ):
            return Categorical(np.concatenate([self.codes, other.codes]), self.categories)
        # remap other's codes into a merged table
        merged, inv = np.unique(
            np.concatenate([self.categories.astype(str), other.categories.astype(str)]),
            return_inverse=True,
        )
        self_map = inv[: len(self.categories)]
        other_map = inv[len(self.categories):]
        codes = np.concatenate(
            [self_map[self.codes].astype(np.int32), other_map[other.codes].astype(np.int32)]
        )
        return Categorical(codes, merged)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Categorical(n={len(self)}, k={len(self.categories)})"


ColumnLike = Union[np.ndarray, Categorical]


def _as_column(values: Any) -> ColumnLike:
    if isinstance(values, Categorical):
        return values
    arr = np.asarray(values)
    if arr.dtype.kind in ("U", "S", "O"):
        try:
            return Categorical.from_values(arr)
        except TypeError:
            return arr  # heterogeneous objects stay as an object column
    return arr


class EventFrame:
    """A minimal, fast, columnar DataFrame for trace events."""

    def __init__(self, columns: Optional[Mapping[str, Any]] = None):
        self._cols: Dict[str, ColumnLike] = {}
        self._n = 0
        if columns:
            for k, v in columns.items():
                self[k] = v

    # -- basic protocol ----------------------------------------------------
    def __len__(self) -> int:
        return self._n

    @property
    def columns(self) -> List[str]:
        return list(self._cols.keys())

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def column(self, name: str) -> ColumnLike:
        """Raw column (Categorical stays Categorical)."""
        return self._cols[name]

    def __getitem__(self, key):
        if isinstance(key, str):
            col = self._cols[key]
            return col.to_strings() if isinstance(col, Categorical) else col
        if isinstance(key, np.ndarray):
            if key.dtype == bool:
                return self.take(np.nonzero(key)[0])
            return self.take(key)
        if isinstance(key, (list, tuple)) and all(isinstance(k, str) for k in key):
            return EventFrame({k: self._cols[k] for k in key})
        if isinstance(key, slice):
            return self.take(np.arange(self._n)[key])
        raise KeyError(key)

    def __setitem__(self, name: str, values: Any) -> None:
        col = _as_column(values)
        n = len(col.codes) if isinstance(col, Categorical) else (
            len(col) if col.ndim > 0 else 0
        )
        if self._cols and n != self._n:
            raise ValueError(f"column {name!r} has length {n}, frame has {self._n}")
        if not self._cols:
            self._n = n
        self._cols[name] = col

    def cat(self, name: str) -> Categorical:
        col = self._cols[name]
        if not isinstance(col, Categorical):
            col = Categorical.from_values(col)
            self._cols[name] = col
        return col

    def codes(self, name: str) -> np.ndarray:
        return self.cat(name).codes

    # -- selection ---------------------------------------------------------
    def take(self, idx: np.ndarray) -> "EventFrame":
        idx = np.asarray(idx)
        out = EventFrame()
        out._n = len(idx)
        for k, c in self._cols.items():
            out._cols[k] = c.take(idx) if isinstance(c, Categorical) else c[idx]
        return out

    def mask(self, m: np.ndarray) -> "EventFrame":
        return self.take(np.nonzero(np.asarray(m, bool))[0])

    def head(self, n: int = 5) -> "EventFrame":
        return self.take(np.arange(min(n, self._n)))

    def copy(self) -> "EventFrame":
        out = EventFrame()
        out._n = self._n
        for k, c in self._cols.items():
            out._cols[k] = (
                Categorical(c.codes.copy(), c.categories) if isinstance(c, Categorical) else c.copy()
            )
        return out

    def drop(self, *names: str) -> "EventFrame":
        out = EventFrame()
        out._n = self._n
        for k, c in self._cols.items():
            if k not in names:
                out._cols[k] = c
        return out

    def rename(self, mapping: Mapping[str, str]) -> "EventFrame":
        out = EventFrame()
        out._n = self._n
        for k, c in self._cols.items():
            out._cols[mapping.get(k, k)] = c
        return out

    # -- ordering ----------------------------------------------------------
    def argsort(self, by: Sequence[str], kind: str = "stable") -> np.ndarray:
        keys = []
        for name in reversed(list(by)):
            col = self._cols[name]
            keys.append(col.codes if isinstance(col, Categorical) else col)
        return np.lexsort(keys) if len(keys) > 1 else np.argsort(keys[0], kind=kind)

    def sort_by(self, by: Union[str, Sequence[str]]) -> "EventFrame":
        if isinstance(by, str):
            by = [by]
        return self.take(self.argsort(by))

    # -- aggregation -------------------------------------------------------
    def groupby_agg(
        self,
        by: Union[str, Sequence[str]],
        aggs: Mapping[str, Union[str, Callable[[np.ndarray], Any]]],
        count_name: Optional[str] = None,
    ) -> "EventFrame":
        """Vectorized groupby: lexsort on keys then reduceat per segment.

        ``aggs`` maps column name -> one of {"sum","mean","min","max","std",
        "median","first","last"} or a callable applied per group (slow path).
        """
        if isinstance(by, str):
            by = [by]
        if self._n == 0:
            out = EventFrame()
            for b in by:
                out[b] = np.asarray([])
            for c in aggs:
                out[c] = np.asarray([])
            return out
        order = self.argsort(by)
        key_codes = []
        for name in by:
            col = self._cols[name]
            key_codes.append((col.codes if isinstance(col, Categorical) else col)[order])
        # group boundary where any key changes
        changed = np.zeros(len(order), dtype=bool)
        changed[0] = True
        for kc in key_codes:
            changed[1:] |= kc[1:] != kc[:-1]
        starts = np.nonzero(changed)[0]
        out = EventFrame()
        for name, kc in zip(by, key_codes):
            col = self._cols[name]
            vals = kc[starts]
            if isinstance(col, Categorical):
                out[name] = Categorical(vals, col.categories)
            else:
                out[name] = vals
        counts = np.diff(np.append(starts, len(order)))
        if count_name:
            out[count_name] = counts
        for cname, how in aggs.items():
            col = self._cols[cname]
            vals = (col.codes if isinstance(col, Categorical) else col)[order]
            if callable(how):
                ends = np.append(starts[1:], len(order))
                out[cname] = np.asarray([how(vals[s:e]) for s, e in zip(starts, ends)])
                continue
            if how == "sum":
                res = np.add.reduceat(vals, starts)
            elif how == "mean":
                res = np.add.reduceat(vals.astype(np.float64), starts) / counts
            elif how == "min":
                res = np.minimum.reduceat(vals, starts)
            elif how == "max":
                res = np.maximum.reduceat(vals, starts)
            elif how == "first":
                res = vals[starts]
            elif how == "last":
                res = vals[np.append(starts[1:], len(order)) - 1]
            elif how == "std":
                s1 = np.add.reduceat(vals.astype(np.float64), starts)
                s2 = np.add.reduceat(vals.astype(np.float64) ** 2, starts)
                res = np.sqrt(np.maximum(s2 / counts - (s1 / counts) ** 2, 0.0))
            elif how == "median":
                ends = np.append(starts[1:], len(order))
                res = np.asarray([np.median(vals[s:e]) for s, e in zip(starts, ends)])
            else:
                raise ValueError(f"unknown agg {how!r}")
            out[cname] = res
        return out

    # -- io / display ------------------------------------------------------
    def to_dict(self) -> Dict[str, np.ndarray]:
        return {k: self[k] for k in self.columns}

    def to_csv(self, path_or_buf=None) -> Optional[str]:
        buf = io.StringIO() if path_or_buf is None else path_or_buf
        close = False
        if isinstance(buf, str):
            buf = open(buf, "w")
            close = True
        cols = self.columns
        buf.write(",".join(cols) + "\n")
        mats = [self[c] for c in cols]
        for i in range(self._n):
            buf.write(",".join(str(m[i]) for m in mats) + "\n")
        if close:
            buf.close()
            return None
        if path_or_buf is None:
            return buf.getvalue()
        return None

    def __repr__(self) -> str:
        n_show = min(self._n, 10)
        cols = self.columns
        if not cols:
            return "EventFrame(empty)"
        widths = {}
        cells = {}
        for c in cols:
            vals = self[c][:n_show]
            text = [_fmt(v) for v in vals]
            widths[c] = max(len(c), max((len(t) for t in text), default=0))
            cells[c] = text
        header = "  ".join(c.rjust(widths[c]) for c in cols)
        lines = [header]
        for i in range(n_show):
            lines.append("  ".join(cells[c][i].rjust(widths[c]) for c in cols))
        if self._n > n_show:
            lines.append(f"... ({self._n} rows x {len(cols)} cols)")
        return "\n".join(lines)


def _fmt(v: Any) -> str:
    if isinstance(v, (float, np.floating)):
        return f"{v:.6g}"
    return str(v)


_DOWNCASTS = (np.int8, np.int16, np.int32)


def optimize_dtypes(frame: EventFrame) -> EventFrame:
    """Downcast integer columns in place to the narrowest dtype that holds
    their values (ingest-side memory optimization).

    Every consumer converts through ``np.asarray(col, np.int64/float64)``
    before arithmetic, so narrowing the *storage* dtype is lossless; for
    trace data it typically shrinks process/thread/partner/tag columns 4-8×
    and (for short traces) timestamps 2×.  String columns are already
    dictionary-encoded by ``Categorical``.  Returns the same frame.
    """
    for name in frame.columns:
        col = frame.column(name)
        if isinstance(col, Categorical) or not isinstance(col, np.ndarray):
            continue
        if col.dtype.kind != "i" or col.dtype.itemsize <= 4 or len(col) == 0:
            continue
        lo, hi = int(col.min()), int(col.max())
        for dt in _DOWNCASTS:
            info = np.iinfo(dt)
            if info.min <= lo and hi <= info.max:
                frame._cols[name] = col.astype(dt)
                break
    return frame


def concat(frames: Sequence[EventFrame]) -> EventFrame:
    frames = [f for f in frames if len(f) > 0]
    if not frames:
        return EventFrame()
    cols = frames[0].columns
    out = EventFrame()
    for c in cols:
        first = frames[0].column(c)
        if isinstance(first, Categorical):
            acc = first
            for f in frames[1:]:
                nxt = f.column(c)
                if not isinstance(nxt, Categorical):
                    nxt = Categorical.from_values(np.asarray(nxt).astype(str))
                acc = acc.append(nxt)
            out[c] = acc
        else:
            out[c] = np.concatenate([np.asarray(f.column(c)) for f in frames])
    return out
