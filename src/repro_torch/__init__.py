"""repro_torch — the PyTorch + CUDA port of the Pipit reproduction.

A package of its own beside the JAX reference :mod:`repro`: it imports
``torch`` and ``numpy``, never ``jax`` and nothing of ``repro``.  The main
path — ``Trace.open`` → structure → lazy ``trace.query()`` plans → the
kernel-backed analysis ops (``flat_profile``, ``time_profile``,
``load_imbalance``, ``comm_matrix``, ``message_histogram``,
``stragglers``), in memory or out of core (``Trace.open(...,
streaming=True)``), compared across runs (``TraceSet``,
``Trace.multirun_analysis``) and diagnosed (``trace.diagnose()``) — runs
its reductions in hand-written Hopper kernels (``repro_torch/csrc``) on the
card unless the caller asks for the CPU (``device="cpu"``), where the
kernels' plain PyTorch versions run.  The rest of the paper's analysis API
(idle time, communication by process and over time, the comm/comp
breakdown, lateness, the critical path, pattern detection and the plots)
runs on the host, as in the reference.
"""

from .core import EventFrame, Trace, TraceSet

__all__ = ["Trace", "TraceSet", "EventFrame"]
