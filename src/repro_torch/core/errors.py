"""Shared error types and the ingest report for fault-tolerant reads.

A copy of :mod:`repro.core.errors` (the port imports nothing of the JAX
package).  The port's jsonl reader accepts the same ``on_error`` policy:

* ``"strict"`` (default) — any malformed input raises :class:`TraceReadError`
  with the file path and the most precise locus available (line number for
  text formats, byte offset for binary ones).  Nothing is silently dropped.
* ``"skip"`` (text/document readers) — malformed records are dropped and
  counted; the surviving rows are exactly the rows a strict read of an
  undamaged copy would produce for them, so eager == streaming == parallel
  digest identity holds over the survivors.

Counts land in an :class:`IngestReport` exposed as ``Trace.ingest_report()``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

__all__ = ["TraceReadError", "IngestReport", "check_on_error",
           "require_nonempty"]

#: cap on per-path stored error samples (counts are always exact)
MAX_ERROR_SAMPLES = 8


class TraceReadError(ValueError):
    """A trace file could not be read (or contains malformed records under
    the strict policy).  Carries the path and an optional locus so the
    message always says *where*."""

    def __init__(self, path: str, reason: str,
                 locus: Optional[str] = None):
        self.path = str(path)
        self.reason = reason
        self.locus = locus
        where = f"{self.path}:{locus}" if locus else self.path
        super().__init__(f"{where}: {reason}")


def check_on_error(value: str, allowed: Tuple[str, ...]) -> str:
    if value not in allowed:
        raise ValueError(f"on_error must be one of {allowed}, got {value!r}")
    return value


def require_nonempty(path: str, size: int, minimum: int = 1,
                     what: str = "trace") -> None:
    """Raise the canonical empty/too-short error for ``path``."""
    if size == 0:
        raise TraceReadError(path, f"empty file (0 bytes) — not a readable "
                                   f"{what}")
    if size < minimum:
        raise TraceReadError(path, f"too-short file ({size} bytes, a "
                                   f"{what} needs at least {minimum})")


class IngestReport:
    """Exact per-path accounting of what a tolerant read kept and dropped.

    One entry per source path with ``rows`` (surviving rows), ``skipped``
    (individually identified records dropped), ``bytes_lost`` (unparseable
    tail bytes for document formats, where a per-record count does not
    exist), and up to ``MAX_ERROR_SAMPLES`` error strings.  Re-reading the
    same path (streaming plans scan a source more than once) resets that
    path's entry first, so counts reflect one pass, never a sum of passes.
    """

    def __init__(self) -> None:
        self._paths: Dict[str, dict] = {}

    # -- recording ---------------------------------------------------------
    def begin(self, path: str) -> None:
        self._paths[str(path)] = {"rows": 0, "skipped": 0, "bytes_lost": 0,
                                  "errors": []}

    def _entry(self, path: str) -> dict:
        e = self._paths.get(str(path))
        if e is None:
            self.begin(path)
            e = self._paths[str(path)]
        return e

    def add_rows(self, path: str, n: int) -> None:
        self._entry(path)["rows"] += int(n)

    def skip(self, path: str, n: int, locus: str, reason: str) -> None:
        e = self._entry(path)
        e["skipped"] += int(n)
        if len(e["errors"]) < MAX_ERROR_SAMPLES:
            e["errors"].append(f"{locus}: {reason}")

    def lose_bytes(self, path: str, n: int, locus: str, reason: str) -> None:
        e = self._entry(path)
        e["bytes_lost"] += int(n)
        if len(e["errors"]) < MAX_ERROR_SAMPLES:
            e["errors"].append(f"{locus}: {reason}")

    # -- reading -----------------------------------------------------------
    @property
    def clean(self) -> bool:
        return all(e["skipped"] == 0 and e["bytes_lost"] == 0
                   for e in self._paths.values())

    def total_skipped(self) -> int:
        return sum(e["skipped"] for e in self._paths.values())

    def errors(self) -> List[str]:
        return [f"{p} {m}" for p, e in sorted(self._paths.items())
                for m in e["errors"]]

    def as_dict(self) -> dict:
        return {"clean": self.clean,
                "paths": {p: dict(e, errors=list(e["errors"]))
                          for p, e in self._paths.items()}}

    def __repr__(self) -> str:
        n = len(self._paths)
        return (f"IngestReport(paths={n}, skipped={self.total_skipped()}, "
                f"clean={self.clean})")
