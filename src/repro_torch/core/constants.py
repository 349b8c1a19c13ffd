"""Canonical column names of the uniform trace data model (paper Fig. 1).

A copy of :mod:`repro.core.constants`: the port keeps its own so that it
imports nothing of the JAX package.
"""

TS = "Timestamp (ns)"
ET = "Event Type"
NAME = "Name"
PROC = "Process"
THREAD = "Thread"

# Event Type categories
ENTER = "Enter"
LEAVE = "Leave"
INSTANT = "Instant"

# normalized message columns (NaN / -1 where not applicable)
MSG_SIZE = "_msg_size"
PARTNER = "_partner"
TAG = "_tag"

# normalized message instant names (OTF2 nomenclature)
MPI_SEND = "MpiSend"
MPI_RECV = "MpiRecv"

# derived columns
MATCH = "_matching_event"
MATCH_TS = "_matching_timestamp"
DEPTH = "_depth"
PARENT = "_parent"
INC = "time.inc"
EXC = "time.exc"
CCT_NODE = "_cct_node"

# every column invalidated by row selection (single source of truth for the
# strip/remap paths in trace.py and query.py)
DERIVED_COLUMNS = (MATCH, MATCH_TS, DEPTH, PARENT, INC, EXC, CCT_NODE)

# default predicates
DEFAULT_COMM_PREFIXES = (
    "MPI_", "mpi_", "nccl", "Nccl", "all-gather", "all-reduce", "reduce-scatter",
    "all-to-all", "collective-permute", "send", "recv", "Isend", "Irecv",
)
DEFAULT_IDLE_NAMES = ("MPI_Wait", "MPI_Waitall", "MPI_Recv", "Idle", "MPI_Barrier")
