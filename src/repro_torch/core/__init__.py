"""repro_torch.core — the port of :mod:`repro.core` along the main path:
the columnar event model, structure derivation and the calling context
tree, the op and reader registries, filters and lazy query plans, the
out-of-core streaming executor, the six kernel-backed analysis ops behind
``Trace`` (``stragglers`` among them), the host ops of the rest of the
paper's analysis API, the detector suite (``diagnose``), multi-trace
comparison (``TraceSet``, ``SetQuery``), live ingestion (``LiveTrace``,
``LiveTraceSet``) and the registries' decorators users extend it with.
The public names are the reference's, bar its backend table."""

from .cct import CCT, CCTNode
from .constants import (ENTER, ET, EXC, INC, INSTANT, LEAVE, MPI_RECV,
                        MPI_SEND, MSG_SIZE, NAME, PARTNER, PROC, TAG, THREAD,
                        TS)
from .detectors import (DetectorSpec, Findings, get_detector, is_comm_name,
                        list_detectors, register_detector)
from .diff import SetQuery, TraceSet
from .filters import Filter, time_window_filter
from .frame import Categorical, EventFrame, concat, optimize_dtypes
from .liveset import Coverage, LiveTraceSet
from .ops_patterns import mass, matrix_profile
from .query import TraceQuery, scan
from .registry import (PlanHints, list_ops, list_readers, register_chunked,
                       register_op, register_reader, register_streaming)
from .streaming import (LiveResult, LiveTrace, StreamingTrace,
                        StreamingUnsupported, Watermark)
from .trace import Trace

__all__ = [
    "Trace", "TraceQuery", "scan", "TraceSet", "SetQuery", "StreamingTrace",
    "StreamingUnsupported", "LiveTrace", "LiveResult", "Watermark",
    "LiveTraceSet", "Coverage", "Filter", "time_window_filter", "CCT",
    "CCTNode", "mass", "matrix_profile",
    "register_detector", "get_detector", "list_detectors", "DetectorSpec",
    "Findings", "is_comm_name",
    "EventFrame", "Categorical", "concat", "optimize_dtypes",
    "register_op", "register_reader", "register_streaming",
    "register_chunked", "PlanHints", "list_ops", "list_readers",
    "TS", "ET", "NAME", "PROC", "THREAD", "ENTER", "LEAVE", "INSTANT",
    "INC", "EXC", "MSG_SIZE", "PARTNER", "TAG", "MPI_SEND", "MPI_RECV",
]
