"""Rank-failure-tolerant live monitoring of an N-rank trace shard fleet.

Mirrors :mod:`repro.core.liveset`.  A job traced by
:class:`repro_torch.runtime.tracer.Tracer` with a sink writes one
append-mode pack shard per rank and a heartbeat file (``rank_<r>.pack`` /
``rank_<r>.pack.hb``).  :class:`LiveTraceSet` is the monitor: it watches
the shard directory and classes each rank by heartbeat age,

* **live**: younger than ``lag_timeout`` (or a clean ``final``
  heartbeat: the rank shut down after flushing everything),
* **lagging**: older than ``lag_timeout`` but younger than
  ``dead_timeout``, a straggler still included in queries,
* **dead**: older than ``dead_timeout``, excluded from queries; its
  committed prefix is reported but not read,

and runs **degraded-mode queries** over the survivors (live and
lagging), their kernels on ``device``, returning a :class:`Coverage`
report with every result: which ranks contributed, each rank's
committed watermark, and the staleness spread, so a missing rank is part
of the answer, never a silent omission.

Timeouts read an injectable ``clock`` (``time.time`` by default), so
tests can age ranks without sleeping.  ``to_traceset`` hands the
survivors to the comparison ops as a ``TraceSet`` of per-rank handles.
``fold=`` is every live handle's it builds (``Trace.open``'s): with
``"chunks"`` the ops fold each chunk into bounded state.
"""

from __future__ import annotations

import glob
import os
import re
import time
from typing import Any, Dict, List, Optional, Tuple

from .accel import resolve_device
from .streaming import DEFAULT_CHUNK_ROWS, LiveTrace, Watermark, check_fold

__all__ = ["Coverage", "LiveTraceSet"]

_RANK_RE = re.compile(r"(\d+)")


def _rank_of(path: str, hb: Optional[dict], fallback: int) -> int:
    """Rank id for a shard: heartbeat field, else the first integer in
    the filename (``rank_3.pack`` → 3), else positional index."""
    if hb and isinstance(hb.get("rank"), int):
        return hb["rank"]
    m = _RANK_RE.search(os.path.basename(path))
    return int(m.group(1)) if m else fallback


class Coverage:
    """What a degraded-mode result actually covers.

    ``per_rank`` maps rank id → ``{status, path, rows, ts_max,
    heartbeat_age, finalized}`` for **every** discovered rank, dead ones
    included (their committed watermark is still reported — the data is
    durable even if the writer is gone).  ``staleness_spread`` is the
    max − min committed ``ts_max`` across included ranks (same clock
    domain as the tracer timestamps): how far the freshest included rank
    has run ahead of the stalest.  ``degraded`` is True whenever any
    discovered rank was excluded.
    """

    __slots__ = ("ranks_total", "included", "missing", "per_rank",
                 "staleness_spread", "degraded")

    def __init__(self, per_rank: Dict[int, dict]):
        self.per_rank = {r: dict(info) for r, info in per_rank.items()}
        self.ranks_total = len(self.per_rank)
        self.included = sorted(r for r, i in self.per_rank.items()
                               if i["status"] != "dead")
        self.missing = sorted(r for r, i in self.per_rank.items()
                              if i["status"] == "dead")
        ts = [self.per_rank[r]["ts_max"] for r in self.included
              if self.per_rank[r]["ts_max"] is not None]
        self.staleness_spread = (max(ts) - min(ts)) if len(ts) > 1 else 0
        self.degraded = bool(self.missing)

    def as_dict(self) -> dict:
        return {"ranks_total": self.ranks_total,
                "included": list(self.included),
                "missing": list(self.missing),
                "degraded": self.degraded,
                "staleness_spread": self.staleness_spread,
                "per_rank": {str(r): dict(i)
                             for r, i in sorted(self.per_rank.items())}}

    def __repr__(self) -> str:  # pragma: no cover
        return (f"Coverage({len(self.included)}/{self.ranks_total} ranks"
                f"{', missing ' + str(self.missing) if self.missing else ''}"
                f", spread={self.staleness_spread})")


class LiveTraceSet:
    """Watch a directory of per-rank append shards; query the survivors.

    ``refresh()`` re-globs ``pattern`` under ``root``, reads each shard's
    heartbeat (falling back to the shard file's mtime when a rank never
    wrote one), classifies ranks live/lagging/dead, and rebuilds the
    underlying :class:`LiveTrace` when the survivor set changed (or just
    re-snapshots it when not).  ``run()`` refreshes, executes a terminal
    op over the survivors' committed prefixes, and returns ``(value,
    coverage, watermark)``.  Zero survivors raises — an all-dead fleet
    must not masquerade as an empty-but-healthy one.
    """

    def __init__(self, root: str, pattern: str = "rank_*.pack",
                 lag_timeout: float = 2.0, dead_timeout: float = 10.0,
                 chunk_rows: Optional[int] = None,
                 processes: Optional[int] = None, executor: str = "auto",
                 cache: bool = True, clock=time.time, device="cuda",
                 fold: str = "once", **reader_kwargs):
        if dead_timeout < lag_timeout:
            raise ValueError("dead_timeout must be >= lag_timeout")
        self.root = os.fspath(root)
        self.pattern = pattern
        self.lag_timeout = float(lag_timeout)
        self.dead_timeout = float(dead_timeout)
        self.chunk_rows = chunk_rows
        self.processes = processes
        self.executor = executor
        self.cache = cache
        self.clock = clock
        self.device = resolve_device(device)
        self.fold = check_fold(fold)
        self.reader_kwargs = dict(reader_kwargs)
        self._lt: Optional[LiveTrace] = None
        self._coverage: Optional[Coverage] = None
        self.refresh()

    # -- classification ------------------------------------------------------
    def _classify(self) -> Dict[int, dict]:
        from ..readers.pack import committed_prefix
        from ..runtime.tracer import read_heartbeat
        now = self.clock()
        per_rank: Dict[int, dict] = {}
        paths = sorted(glob.glob(os.path.join(self.root, self.pattern)))
        for idx, path in enumerate(paths):
            hb = read_heartbeat(path)
            if hb is not None and hb.get("wall") is not None:
                age = max(0.0, now - float(hb["wall"]))
            else:
                try:
                    age = max(0.0, now - os.stat(path).st_mtime)
                except OSError:
                    continue  # shard vanished between glob and stat
            wm = committed_prefix(path)["watermark"]
            if hb is not None and hb.get("final"):
                status = "live"      # clean shutdown: complete, not stale
            elif age <= self.lag_timeout:
                status = "live"
            elif age <= self.dead_timeout:
                status = "lagging"
            else:
                status = "dead"
            rank = _rank_of(path, hb, idx)
            per_rank[rank] = {
                "status": status, "path": path,
                "rows": wm["rows"], "ts_max": wm["ts_max"],
                "finalized": wm["finalized"],
                "heartbeat_age": round(age, 3),
            }
        return per_rank

    def refresh(self) -> Coverage:
        """Re-scan the fleet; returns the new :class:`Coverage`."""
        per_rank = self._classify()
        cov = Coverage(per_rank)
        survivor_paths = [per_rank[r]["path"] for r in cov.included]
        if self._lt is not None and list(self._lt.paths) == survivor_paths:
            self._lt.refresh()   # same fleet — just advance the snapshot
        elif survivor_paths:
            self._lt = LiveTrace(
                survivor_paths,
                chunk_rows=self.chunk_rows or DEFAULT_CHUNK_ROWS,
                processes=self.processes, executor=self.executor,
                cache=self.cache, label=os.path.basename(self.root),
                device=self.device, fold=self.fold, **self.reader_kwargs)
        else:
            self._lt = None
        self._coverage = cov
        return cov

    # -- introspection -------------------------------------------------------
    @property
    def coverage(self) -> Coverage:
        return self._coverage

    @property
    def watermark(self) -> Optional[Watermark]:
        """Combined watermark over the survivors (None when all dead)."""
        return self._lt.watermark if self._lt is not None else None

    def members(self) -> Dict[int, dict]:
        """Per-rank classification snapshot (rank → info dict)."""
        return {r: dict(i) for r, i in self._coverage.per_rank.items()}

    # -- execution -----------------------------------------------------------
    def trace(self) -> LiveTrace:
        """The survivor-spanning :class:`LiveTrace` handle as of the last
        refresh.  Raises when every rank is dead."""
        if self._lt is None:
            raise RuntimeError(
                f"no surviving ranks under {self.root!r} "
                f"(all {self._coverage.ranks_total} dead or none found) — "
                f"refusing to serve an empty result as healthy")
        return self._lt

    def run(self, op_name: str, *args: Any, **kwargs: Any
            ) -> Tuple[Any, Coverage, Watermark]:
        """Refresh, run a terminal op over the survivors' committed
        prefixes, return ``(value, coverage, watermark)``."""
        cov = self.refresh()
        lt = self.trace()
        res = lt.run_with_watermark(op_name, *args, **kwargs)
        return res.value, cov, res.watermark

    def query(self):
        """A lazy query over the survivors (no auto-refresh — pin first)."""
        return self.trace().query()

    def to_traceset(self):
        """The survivors as a :class:`~repro_torch.core.diff.TraceSet` of
        per-rank live handles labelled ``rank<r>``, on the set's device —
        for cross-rank comparison ops over the committed prefixes."""
        from .diff import TraceSet
        cov = self._coverage
        members: List[LiveTrace] = []
        labels: List[str] = []
        for r in cov.included:
            members.append(LiveTrace(
                [cov.per_rank[r]["path"]],
                chunk_rows=self.chunk_rows or DEFAULT_CHUNK_ROWS,
                cache=self.cache, label=f"rank{r}", device=self.device,
                fold=self.fold, **self.reader_kwargs))
            labels.append(f"rank{r}")
        return TraceSet(members, labels=labels)

    def __repr__(self) -> str:  # pragma: no cover
        c = self._coverage
        return (f"LiveTraceSet({self.root!r}, {len(c.included)}/"
                f"{c.ranks_total} ranks live)")
