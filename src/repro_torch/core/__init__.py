"""repro_torch.core — the port of :mod:`repro.core` along the main path:
the columnar event model, structure derivation, the op and reader
registries, and the five kernel-backed analysis ops behind ``Trace``."""

from .constants import (ENTER, ET, EXC, INC, INSTANT, LEAVE, MPI_RECV,
                        MPI_SEND, MSG_SIZE, NAME, PARTNER, PROC, TAG, THREAD,
                        TS)
from .frame import Categorical, EventFrame, concat, optimize_dtypes
from .registry import list_ops, list_readers, register_op, register_reader
from .trace import Trace

__all__ = [
    "Trace", "EventFrame", "Categorical", "concat", "optimize_dtypes",
    "register_op", "register_reader", "list_ops", "list_readers",
    "TS", "ET", "NAME", "PROC", "THREAD", "ENTER", "LEAVE", "INSTANT",
    "INC", "EXC", "MSG_SIZE", "PARTNER", "TAG", "MPI_SEND", "MPI_RECV",
]
