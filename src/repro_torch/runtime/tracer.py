"""Host-side tracer: the port's own runs emit Pipit-native traces.

Mirrors :mod:`repro.runtime.tracer`.  Events use the uniform data model:
Enter/Leave pairs, instants and messages with nanosecond timestamps per
logical process.  ``to_trace()`` returns a :class:`repro_torch.Trace`
whose ops run on ``device``; ``save_jsonl`` writes the native format the
jsonl reader loads back.

**Live mode** (``sink="rank_0.pack"``): the tracer spills its buffer to an
append-mode pack shard (:meth:`repro_torch.readers.pack.PackWriter.open_append`)
every ``flush_every`` events *and* at least every ``heartbeat_interval``
seconds, each flush ending in a durable commit and an atomically replaced
heartbeat record (``<sink>.hb``).  The buffer is therefore bounded, and a
monitor (:class:`repro_torch.core.liveset.LiveTraceSet`) can watch the
shard directory, query the committed prefix while the job runs, and class
this rank as live, lagging or dead from its heartbeat.  A killed tracer
loses at most the uncommitted tail since its last flush.

Without a sink the tracer buffers in memory (with a one-time warning past
``max_buffer_events``; it never drops events).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
import warnings
from typing import Dict, List, Optional

import numpy as np

from ..core.constants import (ENTER, ET, LEAVE, MPI_RECV, MPI_SEND, MSG_SIZE,
                              NAME, PARTNER, PROC, TAG, TS)
from ..core.frame import EventFrame
from ..core.trace import Trace

__all__ = ["Tracer", "write_heartbeat", "read_heartbeat"]

#: wall-clock heartbeat cadence is checked every this many events, so the
#: hot _push path stays a couple of list appends
_HB_CHECK_EVERY = 256


def write_heartbeat(sink: str, rank: int, events: int, ts_max,
                    seq: int, wall: Optional[float] = None,
                    final: bool = False) -> str:
    """Atomically (tmp + rename) write the heartbeat record next to a
    shard: ``<sink>.hb`` with {rank, wall, events, ts_max, seq, pid,
    final}.  Readers classify the rank's liveness from ``wall`` age."""
    hb = {"rank": int(rank), "wall": time.time() if wall is None else wall,
          "events": int(events),
          "ts_max": None if ts_max is None else int(ts_max),
          "seq": int(seq), "pid": os.getpid(), "final": bool(final)}
    path = sink + ".hb"
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(hb, f)
    os.replace(tmp, path)
    return path


def read_heartbeat(sink: str) -> Optional[dict]:
    """The shard's heartbeat record, or None when absent/unparseable."""
    try:
        with open(sink + ".hb") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


class Tracer:
    """Event recorder for one logical process (rank).

    ``sink=None`` (default): pure in-memory buffering, list-backed —
    ``to_trace()`` / ``save_jsonl`` consume the buffer.

    ``sink="<path>.pack"``: bounded-buffer live mode.  The buffer spills
    to an append-mode pack shard with a durable commit every
    ``flush_every`` events and at least every ``heartbeat_interval``
    seconds of wall time (checked every few hundred events), each flush
    also refreshing the ``<sink>.hb`` heartbeat.  ``close()`` flushes the
    tail and (by default) finalizes the shard into an ordinary pack.
    With a sink, ``to_trace()`` only sees the *unflushed tail* — open the
    shard itself (``Trace.open(sink, live=True)``) for the full stream.
    """

    def __init__(self, process: int = 0, clock=time.perf_counter_ns,
                 sink: Optional[str] = None, flush_every: int = 50_000,
                 heartbeat_interval: float = 1.0, fsync: bool = True,
                 max_buffer_events: int = 2_000_000,
                 chunk_rows: Optional[int] = None,
                 wall_clock=time.time):
        self.process = process
        self.clock = clock
        self._t0 = clock()
        self.sink = os.fspath(sink) if sink is not None else None
        self.flush_every = int(flush_every)
        if self.flush_every <= 0:
            raise ValueError("flush_every must be positive")
        self.heartbeat_interval = float(heartbeat_interval)
        self.max_buffer_events = int(max_buffer_events)
        self._chunk_rows = chunk_rows or self.flush_every
        self._fsync = bool(fsync)
        self._wall = wall_clock
        self._writer = None          # lazily-opened append PackWriter
        self._flushed_events = 0     # events committed to the sink
        self._flush_seq = 0
        self._last_hb = self._wall()
        self._last_ts: Optional[int] = None
        self._warned_unbounded = False
        self._closed = False
        self.ts: List[int] = []
        self.et: List[str] = []
        self.name: List[str] = []
        self.proc: List[int] = []
        self.partner: List[int] = []
        self.size: List[float] = []

    def _now(self) -> int:
        return self.clock() - self._t0

    def enter(self, name: str, proc: Optional[int] = None) -> None:
        self._push(self._now(), ENTER, name, proc)

    def leave(self, name: str, proc: Optional[int] = None) -> None:
        self._push(self._now(), LEAVE, name, proc)

    def instant(self, name: str, proc: Optional[int] = None,
                partner: int = -1, size: float = float("nan"),
                et: str = "Instant") -> None:
        self._push(self._now(), et, name, proc, partner, size)

    def message(self, kind: str, partner: int, size: float,
                proc: Optional[int] = None) -> None:
        """kind: 'send' | 'recv' — models collective traffic as messages."""
        name = MPI_SEND if kind == "send" else MPI_RECV
        self._push(self._now(), "Mpi" + kind.capitalize(), name, proc,
                   partner, size)

    def _push(self, ts, et, name, proc, partner=-1, size=float("nan")):
        self.ts.append(ts)
        self.et.append(et)
        self.name.append(name)
        self.proc.append(self.process if proc is None else proc)
        self.partner.append(partner)
        self.size.append(size)
        n = len(self.ts)
        if self.sink is not None:
            if n >= self.flush_every:
                self.flush()
            elif n % _HB_CHECK_EVERY == 0 and \
                    self._wall() - self._last_hb >= self.heartbeat_interval:
                self.flush()
        elif n > self.max_buffer_events and not self._warned_unbounded:
            self._warned_unbounded = True
            warnings.warn(
                f"Tracer buffer passed {self.max_buffer_events} events "
                f"with no sink — a long run will exhaust memory.  Pass "
                f"sink='<shard>.pack' to spill with bounded memory "
                f"(flush_every={self.flush_every}).",
                RuntimeWarning, stacklevel=3)

    @contextlib.contextmanager
    def span(self, name: str, proc: Optional[int] = None):
        self.enter(name, proc)
        try:
            yield
        finally:
            self.leave(name, proc)

    # -- live sink ---------------------------------------------------------
    def _tail_frame(self) -> EventFrame:
        return EventFrame({
            TS: np.asarray(self.ts, np.int64),
            ET: np.asarray(self.et),
            NAME: np.asarray(self.name),
            PROC: np.asarray(self.proc, np.int64),
            PARTNER: np.asarray(self.partner, np.int64),
            MSG_SIZE: np.asarray(self.size, np.float64),
            TAG: np.zeros(len(self.ts), np.int64),
        })

    def _clear(self) -> None:
        for lst in (self.ts, self.et, self.name, self.proc, self.partner,
                    self.size):
            lst.clear()

    def flush(self) -> dict:
        """Spill the buffer to the sink as one durable commit, refresh the
        heartbeat, clear the buffer.  Returns the shard watermark.  No-op
        buffer still commits (syncs) and heartbeats — an idle rank keeps
        proving it is alive."""
        if self.sink is None:
            raise RuntimeError("Tracer has no sink to flush to")
        if self._closed:
            raise RuntimeError("Tracer is closed")
        if self._writer is None:
            from ..readers.pack import PackWriter
            self._writer = PackWriter.open_append(
                self.sink, chunk_rows=self._chunk_rows, fsync=self._fsync)
        n = len(self.ts)
        if n:
            self._last_ts = int(self.ts[-1])
            self._writer.append(self._tail_frame())
            self._clear()
        wm = self._writer.commit()
        self._flushed_events += n
        self._flush_seq += 1
        self._last_hb = self._wall()
        write_heartbeat(self.sink, self.process, self._flushed_events,
                        self._last_ts, self._flush_seq, wall=self._last_hb)
        return wm

    def close(self, finalize: bool = True, sidecar: bool = False) -> None:
        """Flush the tail and stop writing.  ``finalize=True`` seals the
        shard's footer (it becomes an ordinary pack; ``sidecar=True`` also
        derives/stores the structure sidecar — one whole-shard pass).  The
        final heartbeat is marked ``final`` so monitors report a clean
        shutdown instead of a dead rank."""
        if self.sink is None or self._closed:
            self._closed = True
            return
        self.flush()
        if self._writer is not None and finalize:
            self._writer.finalize(sidecar=sidecar)
        elif self._writer is not None:
            self._writer._out.close()
        write_heartbeat(self.sink, self.process, self._flushed_events,
                        self._last_ts, self._flush_seq, final=True)
        self._writer = None
        self._closed = True

    # -- output ----------------------------------------------------------------
    def to_trace(self, label: Optional[str] = None, device="cuda") -> Trace:
        """The buffered events as an in-memory Trace whose ops run on
        ``device``.  With a sink this is only the unflushed tail: open the
        shard (``Trace.open(sink, live=True)``) for everything
        committed."""
        ev = EventFrame({
            TS: np.asarray(self.ts, np.float64),
            ET: np.asarray(self.et),
            NAME: np.asarray(self.name),
            PROC: np.asarray(self.proc, np.int64),
            PARTNER: np.asarray(self.partner, np.int64),
            MSG_SIZE: np.asarray(self.size, np.float64),
            TAG: np.zeros(len(self.ts), np.int64),
        })
        return Trace.from_events(ev.sort_by([PROC, TS]), label=label,
                                 device=device)

    def save_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for i in range(len(self.ts)):
                d: Dict = {"ts": int(self.ts[i]), "et": self.et[i],
                           "name": self.name[i], "proc": int(self.proc[i])}
                if self.partner[i] >= 0:
                    d["partner"] = int(self.partner[i])
                    d["size"] = float(self.size[i])
                f.write(json.dumps(d) + "\n")
