"""repro_torch.core — the port of :mod:`repro.core` along the main path:
the columnar event model, structure derivation and the calling context
tree, the op and reader registries, filters and lazy query plans, the
out-of-core streaming executor, the six kernel-backed analysis ops behind
``Trace`` (``stragglers`` among them), the host ops of the rest of the
paper's analysis API, the detector suite (``diagnose``) and multi-trace
comparison (``TraceSet``, ``SetQuery``)."""

from .constants import (ENTER, ET, EXC, INC, INSTANT, LEAVE, MPI_RECV,
                        MPI_SEND, MSG_SIZE, NAME, PARTNER, PROC, TAG, THREAD,
                        TS)
from .detectors import (DetectorSpec, Findings, get_detector, is_comm_name,
                        list_detectors, register_detector)
from .diff import SetQuery, TraceSet
from .filters import Filter, time_window_filter
from .frame import Categorical, EventFrame, concat, optimize_dtypes
from .query import TraceQuery
from .registry import list_ops, list_readers, register_op, register_reader
from .streaming import StreamingTrace, StreamingUnsupported
from .trace import Trace

__all__ = [
    "Trace", "TraceQuery", "TraceSet", "SetQuery", "StreamingTrace",
    "StreamingUnsupported", "Filter", "time_window_filter",
    "register_detector", "get_detector", "list_detectors", "DetectorSpec",
    "Findings", "is_comm_name",
    "EventFrame", "Categorical", "concat", "optimize_dtypes",
    "register_op", "register_reader", "list_ops", "list_readers",
    "TS", "ET", "NAME", "PROC", "THREAD", "ENTER", "LEAVE", "INSTANT",
    "INC", "EXC", "MSG_SIZE", "PARTNER", "TAG", "MPI_SEND", "MPI_RECV",
]
