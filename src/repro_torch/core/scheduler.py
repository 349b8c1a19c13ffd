"""Shared execution scheduler: one object owns every worker pool.

Mirrors :mod:`repro.core.scheduler`.  A long-lived trace-query service
(:mod:`repro_torch.serving.tracequery`) holds many handles across many
client sessions; a spawn pool per handle would pay worker start-up (an
interpreter, NumPy and PyTorch per worker) once per handle and
oversubscribe the machine.  The :class:`Scheduler` owns them instead:

* :meth:`spawn_pool`: the spawn pools the parallel plan executor
  (:mod:`repro_torch.core.executor`) fans work units into, one per
  distinct worker count, created on first use and shared by every handle.
  Workers run on the host only and never touch CUDA;
* :meth:`lane`: two bounded thread pools ("interactive" / "bulk") the
  service uses as admission-control lanes: small-window queries run on
  reserved threads that a 10M-event full scan can never occupy.  Lane
  threads launch the op's kernels on the card; they share PyTorch's
  default stream, so launches stay in order.

``get_scheduler()`` returns the process-wide default; tests and embedders
swap it with ``set_scheduler()``.  A handle can still carry its own pool
(``StreamingTrace._pool``): the scheduler is the default owner.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

from ..parallel_util import SharedPool, resolve_processes

__all__ = ["Scheduler", "get_scheduler", "set_scheduler"]


class Scheduler:
    """Process-wide owner of spawn pools and the two service thread lanes.

    ``workers`` bounds the *total* thread-lane budget (default: CPU
    count); ``interactive_workers`` of those are reserved for the
    interactive lane (default: a quarter, at least 1).  Spawn pools are
    sized by their callers (the parallel executor resolves the handle's
    ``processes=``) and deduplicated by size.
    """

    def __init__(self, workers: Optional[int] = None,
                 interactive_workers: Optional[int] = None):
        self.workers = resolve_processes(workers)
        if interactive_workers is None:
            interactive_workers = max(1, self.workers // 4)
        self.interactive_workers = max(1, min(int(interactive_workers),
                                              self.workers))
        self.bulk_workers = max(1, self.workers - self.interactive_workers)
        self._lock = threading.Lock()
        self._spawn_pools: Dict[int, SharedPool] = {}
        self._lanes: Dict[str, ThreadPoolExecutor] = {}
        self._closed = False

    # -- multiprocessing spawn pools (parallel plan executor) -------------
    def spawn_pool(self, processes: Optional[int] = None) -> SharedPool:
        """The shared spawn pool for ``processes`` workers (None = one per
        core).  Pools are created lazily and cached by size, so two handles
        opened with ``processes=4`` fan into the same four workers."""
        n = resolve_processes(processes)
        with self._lock:
            if self._closed:
                raise RuntimeError("scheduler is shut down")
            pool = self._spawn_pools.get(n)
            if pool is None:
                pool = self._spawn_pools[n] = SharedPool(n)
            return pool

    # -- thread lanes (service admission control) -------------------------
    def lane(self, name: str) -> ThreadPoolExecutor:
        """The ``"interactive"`` or ``"bulk"`` thread lane.  Interactive
        threads are reserved: bulk work is never scheduled onto them, which
        is what keeps small-window queries responsive under a full scan."""
        if name not in ("interactive", "bulk"):
            raise ValueError(f'lane must be "interactive" or "bulk", '
                             f'got {name!r}')
        with self._lock:
            if self._closed:
                raise RuntimeError("scheduler is shut down")
            ex = self._lanes.get(name)
            if ex is None:
                n = (self.interactive_workers if name == "interactive"
                     else self.bulk_workers)
                ex = self._lanes[name] = ThreadPoolExecutor(
                    max_workers=n, thread_name_prefix=f"tracequery-{name}")
            return ex

    # -- introspection -----------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {"workers": self.workers,
                    "interactive_workers": self.interactive_workers,
                    "bulk_workers": self.bulk_workers,
                    "spawn_pools": sorted(self._spawn_pools),
                    "lanes": sorted(self._lanes)}

    # -- teardown ----------------------------------------------------------
    def shutdown(self, wait: bool = True) -> None:
        """Close every pool and lane.  Idempotent; a shut-down scheduler
        refuses to hand out new pools."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            pools = list(self._spawn_pools.values())
            lanes = list(self._lanes.values())
            self._spawn_pools.clear()
            self._lanes.clear()
        for ex in lanes:
            ex.shutdown(wait=wait)
        for pool in pools:
            pool.close()


_DEFAULT: Optional[Scheduler] = None
_DEFAULT_LOCK = threading.Lock()


def get_scheduler() -> Scheduler:
    """The process-wide default scheduler (created on first use)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = Scheduler()
        return _DEFAULT


def set_scheduler(scheduler: Optional[Scheduler]) -> Optional[Scheduler]:
    """Swap the default scheduler; returns the previous one (tests restore
    it).  ``None`` resets to lazy re-creation on next use."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        prev, _DEFAULT = _DEFAULT, scheduler
        return prev
