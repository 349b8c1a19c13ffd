"""The Trace object — the port's user-facing entry point (paper §III).

Mirrors :class:`repro.core.trace.Trace` along the main path: open a trace
(``Trace.open`` sniffs the format; ``from_events`` wraps a frame; with
``streaming=True`` it returns an out-of-core
:class:`~repro_torch.core.streaming.StreamingTrace`, with ``live=True`` a
:class:`~repro_torch.core.streaming.LiveTrace`), derive its structure
lazily (enter/leave matching, parents, inclusive/exclusive time, message
matching, the calling context tree) and reduce it with the six
kernel-backed ops, the host ops of the rest of the paper's analysis API
(idle time, per-process and over-time communication, comm/comp overlap,
lateness and the critical path, pattern detection), the detectors
(``diagnose``) or :meth:`Trace.multirun_analysis`; plot it
(``plot_*``, matplotlib imported on first use), or write it as a
columnar pack (:meth:`Trace.save_pack`, :mod:`repro_torch.readers.pack`).
As in the reference, the op methods and the
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
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

# detectors, ops_comm, ops_logical, ops_patterns and ops_summary register
# the ops every query terminal resolves through the registry
from . import (detectors, ops_comm, ops_logical, ops_patterns,  # noqa: F401
               ops_summary, structure)
from .accel import resolve_device
from .cct import CCT
from .constants import (CCT_NODE, DEFAULT_IDLE_NAMES, DEPTH, EXC, INC, MATCH,
                        MATCH_TS, NAME, PARENT, PROC, TS)
from .filters import Filter
from .frame import EventFrame
from .query import TraceQuery

__all__ = ["Trace"]


class Trace:
    """A parallel execution trace: events + derived structure + analysis
    ops that run on ``device``."""

    def __init__(self, events: EventFrame, label: Optional[str] = None,
                 device="cuda", definitions: Optional[dict] = None):
        self.events = events
        #: what the reader kept beside the events (chrome's raw pids, an
        #: OTF2 archive's string / region / location tables, the HLO
        #: reader's model parameters)
        self.definitions = definitions or {}
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
    def from_csv(cls, path, device="cuda", **kw) -> "Trace":
        """Read a CSV trace (:func:`repro_torch.readers.csvreader.
        read_csv`)."""
        from ..readers.csvreader import read_csv
        if isinstance(path, os.PathLike):
            path = os.fspath(path)
        return read_csv(path, device=device, **kw)

    @classmethod
    def from_jsonl(cls, path, device="cuda", **kw) -> "Trace":
        """Read a JSON-lines trace (:func:`repro_torch.readers.jsonl.
        read_jsonl`)."""
        from ..readers.jsonl import read_jsonl
        return read_jsonl(os.fspath(path), device=device, **kw)

    @classmethod
    def from_chrome(cls, path, device="cuda", **kw) -> "Trace":
        """Read a Chrome Trace Format document, such as a ``torch.profiler``
        export (:func:`repro_torch.readers.chrome.read_chrome`)."""
        from ..readers.chrome import read_chrome
        if isinstance(path, os.PathLike):
            path = os.fspath(path)
        return read_chrome(path, device=device, **kw)

    @classmethod
    def from_otf2_json(cls, path, device="cuda", **kw) -> "Trace":
        """Read an OTF2-structured archive, one file or a directory
        (:func:`repro_torch.readers.otf2j.read_otf2_json`)."""
        from ..readers.otf2j import read_otf2_json
        return read_otf2_json(os.fspath(path), device=device, **kw)

    @classmethod
    def from_hlo(cls, hlo_text: str, device="cuda", **kw) -> "Trace":
        """Model a compiled XLA program's text as a per-device timeline
        (:func:`repro_torch.readers.hlo.read_hlo`)."""
        from ..readers.hlo import read_hlo
        return read_hlo(hlo_text, device=device, **kw)

    @classmethod
    def from_events(cls, events: EventFrame, label: Optional[str] = None,
                    device="cuda") -> "Trace":
        return cls(events, label=label, device=device)

    @classmethod
    def open(cls, path, format: str = "auto", device="cuda",
             streaming: bool = False, chunk_rows: Optional[int] = None,
             live: bool = False, processes: Optional[int] = None,
             executor: str = "auto", cache: bool = True,
             fold: Optional[str] = None, **kw):
        """Open a trace of any registered format (``format="auto"`` sniffs
        the content: a CSV header, JSON-lines event keys, a Chrome
        ``traceEvents`` envelope, an OTF2-structured archive — one file or
        a directory — HLO text, or a pipitpack).  A list of paths is read
        as per-location shards through the sharded reader
        (:func:`~repro_torch.readers.parallel.read_parallel`;
        ``processes=N`` fans the shard reads over a spawn pool) and merged
        in (process, time) order.

        ``streaming=True`` returns a
        :class:`~repro_torch.core.streaming.StreamingTrace` instead: an
        out-of-core handle whose ops run chunk by chunk, at most
        ``chunk_rows`` events in memory per chunk, their kernels on
        ``device``; ``processes=N`` / ``executor="parallel"`` fan those
        ops over work units, and ``cache=False`` opts the handle out of the
        plan-result cache (:mod:`repro_torch.core.plancache`).

        ``live=True`` (implies streaming) returns a
        :class:`~repro_torch.core.streaming.LiveTrace` over still-growing
        append-mode pack shards: plans run over the committed prefix
        pinned at the last ``refresh()``, results carry a ``watermark``,
        and a repeated op folds only the newly committed rows.

        ``fold=`` (streaming or live only) picks how a streamed op reduces
        its records: ``"once"`` (the default) buffers them for one kernel
        launch at the end, giving the eager route's bits; ``"chunks"``
        reduces each chunk with one launch into state of fixed size, so
        memory does not grow with the trace (results within the
        ``cardcheck.gate`` of the eager route;
        :class:`~repro_torch.core.streaming.StreamAgg`)."""
        from .. import readers  # noqa: F401 — populates the reader registry
        from .registry import resolve_reader
        if live:
            from .streaming import DEFAULT_CHUNK_ROWS, LiveTrace
            return LiveTrace(path, format=format,
                             chunk_rows=chunk_rows or DEFAULT_CHUNK_ROWS,
                             device=device, processes=processes,
                             executor=executor, cache=cache,
                             fold=fold or "once", **kw)
        if streaming:
            from .streaming import DEFAULT_CHUNK_ROWS, StreamingTrace
            return StreamingTrace(path, format=format,
                                  chunk_rows=chunk_rows or DEFAULT_CHUNK_ROWS,
                                  device=device, processes=processes,
                                  executor=executor, cache=cache,
                                  fold=fold or "once", **kw)
        if fold is not None:
            raise ValueError("fold only applies with streaming=True or "
                             "live=True")
        if chunk_rows is not None:
            raise ValueError("chunk_rows only applies with streaming=True")
        if executor != "auto":
            raise ValueError("executor only applies with streaming=True")
        if cache is not True:
            # an eager open has no handle to opt out; the query terminal's
            # per-call cache= is the in-memory control
            raise ValueError("cache only applies with streaming=True; "
                             "in-memory caching is opt-in per call "
                             "(query terminal cache=True)")
        if isinstance(path, (list, tuple)):
            from ..readers.parallel import read_parallel
            return read_parallel([os.fspath(p) for p in path], kind=format,
                                 processes=processes, device=device, **kw)
        if processes is not None:
            raise ValueError("processes needs streaming=True or a list of "
                             "shard paths")
        path = os.fspath(path)
        return resolve_reader(path, format).open(path, device, **kw)

    # ------------------------------------------------------------------
    # serialization — the columnar binary store
    # ------------------------------------------------------------------
    def save_pack(self, path, chunk_rows: Optional[int] = None,
                  sidecar: bool = True) -> str:
        """Write this trace as a ``pipitpack`` columnar file: reopening it
        (``Trace.open(path)``) maps each column with zero parsing, and with
        ``sidecar=True`` (default) the derived structure is stored too, so
        the reopened trace skips ``derive_structure``.  Returns ``path``."""
        from ..readers.pack import DEFAULT_PACK_CHUNK_ROWS, write_pack
        return write_pack(self, os.fspath(path),
                          chunk_rows=chunk_rows or DEFAULT_PACK_CHUNK_ROWS,
                          sidecar=sidecar)

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

    # paper-named entry points: each derives the structure once
    def _match_caller_callee(self) -> None:
        self._ensure_structure()

    def calc_inc_metrics(self) -> None:
        self._ensure_structure()

    def calc_exc_metrics(self) -> None:
        self._ensure_structure()

    def _create_cct(self) -> CCT:
        return self.cct

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

    @staticmethod
    def multirun_analysis(traces: Sequence["Trace"], metric: str = EXC,
                          top_n: int = 16, device=None) -> EventFrame:
        """Joined flat profiles across runs (§IV-D, Fig. 12): one
        ``seg_sum`` launch per run, on its own device unless ``device``
        names one."""
        return ops_summary.multi_run_analysis(traces, metric=metric,
                                              top_n=top_n, device=device)

    # ------------------------------------------------------------------
    # host ops of the rest of the analysis API (no kernel backs them)
    # ------------------------------------------------------------------
    def idle_time(self, idle_functions: Sequence[str] = DEFAULT_IDLE_NAMES,
                  k: Optional[int] = None, device=None) -> EventFrame:
        return self.run("idle_time", idle_functions=idle_functions, k=k,
                        device=device)

    def comm_by_process(self, output: str = "size",
                        device=None) -> EventFrame:
        return self.run("comm_by_process", output=output, device=device)

    def comm_over_time(self, num_bins: int = 32, output: str = "size",
                       device=None) -> Tuple[np.ndarray, np.ndarray]:
        return self.run("comm_over_time", num_bins=num_bins, output=output,
                        device=device)

    def comm_comp_breakdown(
            self, comm_matcher: Optional[Callable[[str], bool]] = None,
            device=None) -> EventFrame:
        return self.run("comm_comp_breakdown", comm_matcher=comm_matcher,
                        device=device)

    def detect_pattern(self, start_event: Optional[str] = None,
                       device=None, **kw) -> List[EventFrame]:
        return self.run("detect_pattern", start_event=start_event,
                        device=device, **kw)

    def calculate_lateness(self, device=None) -> EventFrame:
        return self.run("calculate_lateness", device=device)

    def lateness_by_process(self, device=None) -> EventFrame:
        return self.run("lateness_by_process", device=device)

    def critical_path_analysis(self, device=None) -> List[EventFrame]:
        return self.run("critical_path_analysis", device=device)

    # ------------------------------------------------------------------
    # automated diagnostics (repro_torch.core.detectors)
    # ------------------------------------------------------------------
    def stragglers(self, device=None, **kw) -> EventFrame:
        return self.run("stragglers", device=device, **kw)

    def diagnose(self, detectors: Optional[Sequence[str]] = None,
                 device=None) -> EventFrame:
        """Run every registered detector (or a named subset) and return one
        severity-ranked Findings frame."""
        return self.run("diagnose", detectors=detectors, device=device)

    def efficiency_metrics(self, num_windows: int = 16,
                           device=None) -> EventFrame:
        return self.run("efficiency_metrics", num_windows=num_windows,
                        device=device)

    def late_sender(self, device=None, **kw) -> EventFrame:
        return self.run("late_sender", device=device, **kw)

    def serialization(self, device=None, **kw) -> EventFrame:
        return self.run("serialization", device=device, **kw)

    def imbalance_root_cause(self, device=None, **kw) -> EventFrame:
        return self.run("imbalance_root_cause", device=device, **kw)

    def pop_efficiency(self, device=None, **kw) -> EventFrame:
        return self.run("pop_efficiency", device=device, **kw)

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

    # ------------------------------------------------------------------
    # visualization (repro_torch.core.viz; matplotlib imported on use)
    # ------------------------------------------------------------------
    def plot_timeline(self, **kw):
        from . import viz
        return viz.plot_timeline(self, **kw)

    def plot_time_profile(self, **kw):
        from . import viz
        return viz.plot_time_profile(self, **kw)

    def plot_comm_matrix(self, **kw):
        from . import viz
        return viz.plot_comm_matrix(self, **kw)

    def plot_comm_by_process(self, **kw):
        from . import viz
        return viz.plot_comm_by_process(self, **kw)

    def plot_message_histogram(self, **kw):
        from . import viz
        return viz.plot_message_histogram(self, **kw)
