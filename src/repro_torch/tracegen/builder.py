"""Append-oriented trace builder producing columnar EventFrames.

Mirrors :mod:`repro.tracegen.builder`: the same events, in the same
(process, time) order, for the same calls; :meth:`TraceBuilder.trace`
puts them in a port Trace on ``device``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.constants import (ENTER, ET, LEAVE, MPI_RECV, MPI_SEND, MSG_SIZE,
                              NAME, PARTNER, PROC, TAG, THREAD, TS)
from ..core.frame import EventFrame
from ..core.trace import Trace

__all__ = ["TraceBuilder"]


class TraceBuilder:
    """Accumulates events in Python lists, emits one columnar EventFrame.

    Generators work per-process with a local clock; ``call``/``send``/``recv``
    advance and return the clock so loops read naturally.
    """

    def __init__(self, with_threads: bool = False):
        self.ts: list = []
        self.et: list = []
        self.name: list = []
        self.proc: list = []
        self.thread: list = []
        self.partner: list = []
        self.size: list = []
        self.tag: list = []
        self.with_threads = with_threads

    # -- primitive events ---------------------------------------------------
    def event(self, ts: float, et: str, name: str, proc: int, thread: int = 0,
              partner: int = -1, size: float = np.nan, tag: int = 0) -> None:
        self.ts.append(ts)
        self.et.append(et)
        self.name.append(name)
        self.proc.append(proc)
        self.thread.append(thread)
        self.partner.append(partner)
        self.size.append(size)
        self.tag.append(tag)

    def enter(self, ts, name, proc, thread=0):
        self.event(ts, ENTER, name, proc, thread)

    def leave(self, ts, name, proc, thread=0):
        self.event(ts, LEAVE, name, proc, thread)

    def call(self, t0: float, dur: float, name: str, proc: int, thread: int = 0
             ) -> float:
        """Enter at t0, Leave at t0+dur; returns the new clock."""
        self.enter(t0, name, proc, thread)
        self.leave(t0 + dur, name, proc, thread)
        return t0 + dur

    def send(self, t0: float, dur: float, proc: int, dst: int, nbytes: float,
             tag: int = 0, thread: int = 0, name: str = "MPI_Send") -> float:
        """A send call wrapping an MpiSend instant at its midpoint."""
        self.enter(t0, name, proc, thread)
        self.event(t0 + dur * 0.5, "MpiSend", MPI_SEND, proc, thread,
                   partner=dst, size=nbytes, tag=tag)
        self.leave(t0 + dur, name, proc, thread)
        return t0 + dur

    def recv(self, t0: float, dur: float, proc: int, src: int, nbytes: float,
             tag: int = 0, thread: int = 0, name: str = "MPI_Recv") -> float:
        self.enter(t0, name, proc, thread)
        self.event(t0 + dur * 0.9, "MpiRecv", MPI_RECV, proc, thread,
                   partner=src, size=nbytes, tag=tag)
        self.leave(t0 + dur, name, proc, thread)
        return t0 + dur

    # -- output ---------------------------------------------------------------
    def frame(self) -> EventFrame:
        ev = EventFrame({
            TS: np.asarray(self.ts, np.float64),
            ET: np.asarray(self.et),
            NAME: np.asarray(self.name),
            PROC: np.asarray(self.proc, np.int64),
            PARTNER: np.asarray(self.partner, np.int64),
            MSG_SIZE: np.asarray(self.size, np.float64),
            TAG: np.asarray(self.tag, np.int64),
        })
        if self.with_threads:
            ev[THREAD] = np.asarray(self.thread, np.int64)
        # canonical (process, time) order like real trace files
        return ev.sort_by([PROC, TS])

    def trace(self, label: Optional[str] = None, device="cuda") -> Trace:
        return Trace.from_events(self.frame(), label=label, device=device)
