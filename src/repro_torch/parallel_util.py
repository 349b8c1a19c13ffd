"""Shared multiprocessing plumbing for the port's parallel code paths.

A copy of :mod:`repro.parallel_util` (the port imports nothing of the
reference package).  One place owns the spawn-safety rules and pool
construction: the sharded reader (:mod:`repro_torch.readers.parallel`) and
the parallel plan executor (:mod:`repro_torch.core.executor`) fan work out
through here, so the serial fallback (stdin / ``-c`` / REPL ``__main__``)
cannot drift between them.

Pools always use the ``spawn`` start method: workers begin from a fresh
interpreter, which is the only start method that is safe after NumPy and
PyTorch have started thread pools (or a CUDA context) in the parent.
Workers import ``repro_torch``, and with it ``torch``, but never touch the
card: they parse, mask, stitch and buffer records on the host.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import threading
from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple

__all__ = ["spawn_pool_ok", "spawn_unsafe_reason", "resolve_processes",
           "map_maybe_parallel", "SharedPool"]


def spawn_pool_ok() -> bool:
    """True when a ``multiprocessing`` spawn pool can start safely.

    Spawned workers re-import ``__main__`` from its ``__file__``.  When
    Python runs from stdin, ``-c``, or an interactive session, ``__main__``
    has no (or a nonexistent) ``__file__`` — the re-import then fails with
    a confusing FileNotFoundError/ModuleNotFoundError deep inside the pool
    (e.g. trying to load ``/tmp/<stdin>``).  Callers fall back to serial
    execution instead of crashing.
    """
    return spawn_unsafe_reason() is None


def spawn_unsafe_reason() -> Optional[str]:
    """Why a spawn pool cannot start, or None when it can.

    The reason string is surfaced in degradation warnings so a user who
    expected parallel execution can see exactly what blocked it.
    """
    import sys
    main = sys.modules.get("__main__")
    f = getattr(main, "__file__", None)
    if f is None:
        return ("__main__ has no importable file (Python running from "
                "stdin, -c, or an interactive session); spawn workers "
                "cannot re-import it")
    try:
        if not os.path.exists(f):
            return (f"__main__ file {f!r} does not exist on disk; spawn "
                    f"workers cannot re-import it")
    except (OSError, ValueError):  # pragma: no cover - exotic paths
        return f"__main__ file {f!r} is not a checkable path"
    return None


def resolve_processes(processes: Optional[int]) -> int:
    """Normalize a ``processes`` request: None means one worker per core."""
    if processes is None:
        return os.cpu_count() or 1
    return max(int(processes), 1)


def map_maybe_parallel(fn: Callable[[Any], Any], items: Sequence,
                       processes: Optional[int]
                       ) -> Tuple[List[Any], bool]:
    """``[fn(x) for x in items]`` through a spawn pool when that is safe
    and worth it; serially otherwise.

    Returns ``(results, pooled)`` — ``pooled`` tells the caller whether a
    pool actually ran (the sharded-reader tests assert on the fallback).
    """
    items = list(items)
    n = resolve_processes(processes) if processes is not None else 1
    if n <= 1 or len(items) <= 1 or not spawn_pool_ok():
        return [fn(a) for a in items], False
    with mp.get_context("spawn").Pool(min(n, len(items))) as pool:
        return pool.map(fn, items), True


class SharedPool:
    """A lazily-created spawn pool shared across several consumers.

    The shared scheduler (:mod:`repro_torch.core.scheduler`) keeps one
    per worker count for every handle, so worker startup (interpreter,
    NumPy and PyTorch imports) is paid once per process, not once per
    handle or terminal op.
    """

    def __init__(self, processes: Optional[int] = None):
        self.processes = resolve_processes(processes)
        self._pool = None
        self._lock = threading.Lock()

    def get(self):
        """The live pool, created on first use.  Raises RuntimeError with
        the spawn-safety reason when a pool cannot start — callers catch it
        and degrade to serial with that reason in the warning.  Safe to
        call from several threads; ``Pool.map`` itself is thread-safe, only
        the lazy creation needs the lock."""
        with self._lock:
            if self._pool is None:
                reason = spawn_unsafe_reason()
                if reason is not None:
                    raise RuntimeError(reason)
                self._pool = mp.get_context("spawn").Pool(self.processes)
            return self._pool

    def map(self, fn: Callable[[Any], Any], items: Sequence) -> List[Any]:
        return self.get().map(fn, list(items))

    def imap(self, fn: Callable[[Any], Any], items: Sequence) -> Iterator:
        """Results in item order, each as soon as it and those before it
        are done (the parent can consume and free them one by one)."""
        return self.get().imap(fn, list(items))

    def close(self) -> None:
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __del__(self):  # pragma: no cover - interpreter teardown
        try:
            self.close()
        except Exception:
            pass
