"""The Trace object — the port's user-facing entry point (paper §III).

Mirrors :class:`repro.core.trace.Trace` along the main path: open a trace
(``Trace.open`` sniffs the format; ``from_events`` wraps a frame; with
``streaming=True`` it returns an out-of-core
:class:`~repro_torch.core.streaming.StreamingTrace`), derive its structure
lazily (enter/leave matching, parents, inclusive/exclusive time, message
matching, the calling context tree) and reduce it with the six
kernel-backed ops.  As in the reference, the op methods and the
data-reduction methods (``filter``, ``slice_time``, ``filter_processes``)
are one-step lazy query plans (:mod:`repro_torch.core.query`); chain them
through :meth:`Trace.query` to fuse selections.

A Trace carries a ``device``: the card (``"cuda"``) unless the caller asks
for the CPU.  Its op methods run their kernels there unless given another
``device=``, and its selections keep it; asking for the card on a machine
without one raises.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

# detectors, ops_comm and ops_summary register the ops every query
# terminal resolves through the registry
from . import detectors, ops_comm, ops_summary, structure  # noqa: F401
from .accel import resolve_device
from .cct import CCT
from .constants import (CCT_NODE, DEPTH, EXC, INC, MATCH, MATCH_TS, NAME,
                        PARENT, PROC, TS)
from .filters import Filter
from .frame import EventFrame, concat
from .query import TraceQuery
from .registry import resolve_reader

__all__ = ["Trace"]


class Trace:
    """A parallel execution trace: events + derived structure + analysis
    ops that run on ``device``."""

    def __init__(self, events: EventFrame, label: Optional[str] = None,
                 device="cuda"):
        self.events = events
        self.label = label
        self.device = resolve_device(device)
        self._structured = False
        self._cct: Optional[CCT] = None
        self._msg_match: Optional[np.ndarray] = None
        self._ingest = None  # IngestReport set by readers (see core.errors)

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------
    @classmethod
    def from_events(cls, events: EventFrame, label: Optional[str] = None,
                    device="cuda") -> "Trace":
        return cls(events, label=label, device=device)

    @classmethod
    def open(cls, path, format: str = "auto", device="cuda",
             streaming: bool = False, chunk_rows: Optional[int] = None,
             live: bool = False, **kw):
        """Open a trace of any registered format (``format="auto"`` sniffs
        the content).  A list of paths is read as per-location shards, one
        after another, and merged in (process, time) order as the
        reference's sharded reader merges them.

        ``streaming=True`` returns a
        :class:`~repro_torch.core.streaming.StreamingTrace` instead: an
        out-of-core handle whose ops run chunk by chunk, at most
        ``chunk_rows`` events in memory per chunk, their kernels on
        ``device``.  ``live=True`` (live pack shards) and ``processes=``
        (the parallel executor) are not yet ported (ROADMAP §A.3)."""
        from .. import readers  # noqa: F401 — populates the reader registry
        if live:
            raise NotImplementedError(
                "Trace.open(live=True) needs live pack shards "
                "(liveset.py, readers/pack.py), which are not yet ported "
                "(ROADMAP §A.3)")
        if streaming:
            from .streaming import DEFAULT_CHUNK_ROWS, StreamingTrace
            return StreamingTrace(path, format=format,
                                  chunk_rows=chunk_rows or DEFAULT_CHUNK_ROWS,
                                  device=device, **kw)
        if chunk_rows is not None:
            raise ValueError("chunk_rows only applies with streaming=True")
        if isinstance(path, (list, tuple)):
            frames = [resolve_reader(os.fspath(p), format)
                      .read(os.fspath(p), device=device, **kw).events
                      for p in path]
            ev = concat(frames).sort_by([PROC, TS])
            return cls(ev, label=f"parallel[{len(frames)}]", device=device)
        path = os.fspath(path)
        return resolve_reader(path, format).read(path, device=device, **kw)

    # ------------------------------------------------------------------
    # basics
    # ------------------------------------------------------------------
    def ingest_report(self):
        """The :class:`~repro_torch.core.errors.IngestReport` of the read
        that produced this trace (a fresh empty one otherwise)."""
        from .errors import IngestReport
        if self._ingest is None:
            self._ingest = IngestReport()
        return self._ingest

    @property
    def num_processes(self) -> int:
        if len(self.events) == 0:
            return 0
        return int(np.asarray(self.events[PROC]).max()) + 1

    def __len__(self) -> int:
        return len(self.events)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"Trace(label={self.label!r}, events={len(self.events)}, "
                f"processes={self.num_processes}, device={self.device})")

    # ------------------------------------------------------------------
    # derived structure (lazy, cached in the frame itself)
    # ------------------------------------------------------------------
    def _ensure_structure(self) -> None:
        if self._structured:
            return
        ev = self.events
        matching, depth, parent, inc, exc = structure.derive_structure(ev)
        ev[MATCH] = matching
        ev[DEPTH] = depth
        ev[PARENT] = parent
        ev[INC] = inc
        ev[EXC] = exc
        ts = np.asarray(ev[TS], np.float64)
        ev[MATCH_TS] = np.where(matching >= 0,
                                ts[np.maximum(matching, 0)], np.nan)
        self._structured = True

    def _ensure_messages(self) -> None:
        if self._msg_match is None:
            self._msg_match = structure.match_messages(self.events)

    @property
    def cct(self) -> CCT:
        """The calling context tree, built once (with the structure it
        needs); each Enter row's node id lands in the ``_cct_node``
        column."""
        if self._cct is None:
            self._ensure_structure()
            self._cct = CCT.build(self.events,
                                  np.asarray(self.events.column(PARENT),
                                             np.int64),
                                  np.asarray(self.events.column(DEPTH)))
            self.events[CCT_NODE] = self._cct.event_node
        return self._cct

    # ------------------------------------------------------------------
    # lazy query plans (§IV-E)
    # ------------------------------------------------------------------
    def query(self) -> TraceQuery:
        """Start a lazy, composable query plan over this trace: chained
        selections fuse into one mask, derived structure is remapped
        instead of recomputed when the selection keeps call pairs intact,
        and registered ops are terminal methods on the returned query."""
        return TraceQuery.from_trace(self)

    def run(self, op_name: str, *args, device=None, **kwargs):
        """Run a registered op as a one-step plan, its prerequisites
        materialized, on ``device`` (default: the trace's)."""
        return self.query().run(op_name, *args, device=device, **kwargs)

    # ------------------------------------------------------------------
    # the kernel-backed ops
    # ------------------------------------------------------------------
    def flat_profile(self, metrics: Sequence[str] = (EXC,),
                     per_process: bool = False, groupby_column: str = NAME,
                     device=None) -> EventFrame:
        return self.run("flat_profile", metrics=metrics,
                        per_process=per_process,
                        groupby_column=groupby_column, device=device)

    def time_profile(self, num_bins: int = 32, metric: str = EXC,
                     normalized: bool = False, device=None) -> EventFrame:
        return self.run("time_profile", num_bins=num_bins, metric=metric,
                        normalized=normalized, device=device)

    def comm_matrix(self, output: str = "size", device=None) -> np.ndarray:
        return self.run("comm_matrix", output=output, device=device)

    def message_histogram(self, bins: int = 10, device=None
                          ) -> Tuple[np.ndarray, np.ndarray]:
        return self.run("message_histogram", bins=bins, device=device)

    def load_imbalance(self, metric: str = EXC, num_processes: int = 5,
                       top_functions: Optional[int] = None,
                       device=None) -> EventFrame:
        return self.run("load_imbalance", metric=metric,
                        num_processes=num_processes,
                        top_functions=top_functions, device=device)

    def stragglers(self, threshold: float = 0.2, device=None) -> EventFrame:
        return self.run("stragglers", threshold=threshold, device=device)

    # ------------------------------------------------------------------
    # §IV-E data reduction — one-step query plans (structure is remapped
    # through the selection when call pairs stay intact)
    # ------------------------------------------------------------------
    def filter(self, f: Filter) -> "Trace":
        """Subset trace by a Filter.  Time-window filters built with
        ``time_window_filter(..., trim="overlap")`` keep the whole call
        when any part of it overlaps the window."""
        return self.query().filter(f).collect()

    def slice_time(self, start: float, end: float,
                   trim: str = "overlap") -> "Trace":
        """Events whose call interval overlaps [start, end] (default), or
        whose own timestamp falls inside with trim="within"."""
        return self.query().slice_time(start, end, trim=trim).collect()

    def filter_processes(self, procs: Sequence[int]) -> "Trace":
        return self.query().restrict_processes(procs).collect()
