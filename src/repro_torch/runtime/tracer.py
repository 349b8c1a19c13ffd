"""Host-side tracer: the port's own runs emit Pipit-native traces.

Mirrors :mod:`repro.runtime.tracer` in its in-memory mode: Enter/Leave
pairs with nanosecond timestamps per logical process, buffered in lists.
``to_trace()`` returns a :class:`repro_torch.Trace` whose ops run on
``device``; ``save_jsonl`` writes the native format the jsonl reader
loads back.  Live mode (``sink=``, append-mode pack shards with
heartbeats) waits for the port of the pack store and raises (ROADMAP §A,
streaming / pack / live); instants and messages come with the slice
whose runtime emits them.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import List, Optional

import numpy as np

from ..core.constants import (ENTER, ET, LEAVE, MSG_SIZE, NAME, PARTNER,
                              PROC, TAG, TS)
from ..core.frame import EventFrame
from ..core.trace import Trace

__all__ = ["Tracer"]


class Tracer:
    """Event recorder for one logical process (rank), buffered in
    memory."""

    def __init__(self, process: int = 0, sink: Optional[str] = None):
        if sink is not None:
            raise NotImplementedError(
                "Tracer(sink=...) live mode needs the pack store, not yet "
                "ported to repro_torch (ROADMAP.md §A: streaming, pack and "
                "live)")
        self.process = process
        self._t0 = time.perf_counter_ns()
        self.ts: List[int] = []
        self.et: List[str] = []
        self.name: List[str] = []
        self.proc: List[int] = []

    def _push(self, et: str, name: str, proc: Optional[int]) -> None:
        self.ts.append(time.perf_counter_ns() - self._t0)
        self.et.append(et)
        self.name.append(name)
        self.proc.append(self.process if proc is None else proc)

    def enter(self, name: str, proc: Optional[int] = None) -> None:
        self._push(ENTER, name, proc)

    def leave(self, name: str, proc: Optional[int] = None) -> None:
        self._push(LEAVE, name, proc)

    @contextlib.contextmanager
    def span(self, name: str, proc: Optional[int] = None):
        self.enter(name, proc)
        try:
            yield
        finally:
            self.leave(name, proc)

    # -- output ----------------------------------------------------------------
    def to_trace(self, label: Optional[str] = None, device="cuda") -> Trace:
        """The buffered events as a Trace whose ops run on ``device``."""
        n = len(self.ts)
        ev = EventFrame({
            TS: np.asarray(self.ts, np.float64),
            ET: np.asarray(self.et),
            NAME: np.asarray(self.name),
            PROC: np.asarray(self.proc, np.int64),
            PARTNER: np.full(n, -1, np.int64),
            MSG_SIZE: np.full(n, np.nan),
            TAG: np.zeros(n, np.int64),
        })
        return Trace.from_events(ev.sort_by([PROC, TS]), label=label,
                                 device=device)

    def save_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for ts, et, name, proc in zip(self.ts, self.et, self.name,
                                          self.proc):
                f.write(json.dumps({"ts": int(ts), "et": et, "name": name,
                                    "proc": int(proc)}) + "\n")
