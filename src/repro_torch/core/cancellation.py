"""Cooperative cancellation for long-running executions.

Mirrors :mod:`repro.core.cancellation`.  The trace-query service enforces
per-request deadlines: when one expires, the event loop answers 504 at
once, but the plan still runs on a scheduler lane thread.  Python threads
cannot be killed, so the work itself has to notice:

* :class:`CancelToken`: a thread-safe flag the deadline watcher sets;
* :func:`cancel_scope`: binds a token to the *current thread* for the
  duration of an execution;
* :func:`check_cancelled`: the cheap check long loops call at natural
  yield points (the streaming engine calls it at every chunk boundary),
  raising :class:`ExecutionCancelled` when the bound token fired.

Only the thread that entered the scope sees the token.  Work fanned out
to a spawn pool does not observe tokens; the serial and streaming paths,
where a runaway full scan pins a lane, cancel within one chunk.  A
kernel launch already queued on the card runs to its end.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Iterator, Optional

__all__ = ["ExecutionCancelled", "CancelToken", "cancel_scope",
           "current_token", "check_cancelled"]


class ExecutionCancelled(RuntimeError):
    """Raised by :func:`check_cancelled` when the current scope's token
    was cancelled (e.g. the request's deadline expired)."""


class CancelToken:
    """A thread-safe one-way cancellation flag."""

    def __init__(self, reason: str = "cancelled"):
        self._flag = threading.Event()
        self.reason = reason

    def cancel(self, reason: Optional[str] = None) -> None:
        if reason is not None:
            self.reason = reason
        self._flag.set()

    @property
    def cancelled(self) -> bool:
        return self._flag.is_set()

    def check(self) -> None:
        if self._flag.is_set():
            raise ExecutionCancelled(self.reason)

    def __repr__(self) -> str:  # pragma: no cover
        state = "cancelled" if self.cancelled else "live"
        return f"CancelToken({state}, reason={self.reason!r})"


_tls = threading.local()


def current_token() -> Optional[CancelToken]:
    """The token bound to this thread by :func:`cancel_scope`, or None."""
    return getattr(_tls, "token", None)


def check_cancelled() -> None:
    """Raise :class:`ExecutionCancelled` if this thread's bound token was
    cancelled; no-op (and near-free) when no scope is active."""
    tok = getattr(_tls, "token", None)
    if tok is not None and tok.cancelled:
        raise ExecutionCancelled(tok.reason)


@contextmanager
def cancel_scope(token: CancelToken) -> Iterator[CancelToken]:
    """Bind ``token`` to the current thread for the duration of the block
    (scopes nest; the previous binding is restored on exit)."""
    prev = getattr(_tls, "token", None)
    _tls.token = token
    try:
        yield token
    finally:
        _tls.token = prev
