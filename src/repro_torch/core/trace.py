"""The Trace object — the port's user-facing entry point (paper §III).

Mirrors :class:`repro.core.trace.Trace` along the main path: open a trace
(``Trace.open`` sniffs the format; ``from_events`` wraps a frame), derive
its structure lazily (enter/leave matching, parents, inclusive/exclusive
time, message matching) and reduce it with the five kernel-backed ops.

A Trace carries a ``device``: the card (``"cuda"``) unless the caller asks
for the CPU.  Its op methods run their kernels there unless given another
``device=``; asking for the card on a machine without one raises.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

from . import ops_comm, ops_summary, structure  # noqa: F401 — registers ops
from .accel import resolve_device
from .constants import (EXC, INC, MATCH, MATCH_TS, NAME, PARENT, PROC, TS)
from .frame import EventFrame, concat
from .registry import get_op, list_ops, resolve_reader

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
             **kw) -> "Trace":
        """Open a trace of any registered format (``format="auto"`` sniffs
        the content).  A list of paths is read as per-location shards, one
        after another, and merged in (process, time) order as the
        reference's sharded driver merges them."""
        from .. import readers  # noqa: F401 — populates the reader registry
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
        ev["_depth"] = depth
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

    def run(self, op_name: str, *args, device=None, **kwargs):
        """Run a registered op with its prerequisites materialized, on
        ``device`` (default: the trace's)."""
        spec = get_op(op_name)
        if spec is None:
            raise ValueError(f"unknown analysis op {op_name!r}; "
                             f"registered: {list_ops()}")
        dev = self.device if device is None else resolve_device(device)
        if spec.needs_structure:
            self._ensure_structure()
        if spec.needs_messages:
            self._ensure_messages()
        return spec.fn(self, *args, device=dev, **kwargs)

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
