"""repro_torch — the PyTorch + CUDA port of the Pipit reproduction.

A package of its own beside the JAX reference :mod:`repro`: it imports
``torch`` and ``numpy``, never ``jax`` and nothing of ``repro``.  The main
path — ``Trace.open`` → structure → lazy ``trace.query()`` plans → the
kernel-backed analysis ops (``flat_profile``, ``time_profile``,
``load_imbalance``, ``comm_matrix``, ``message_histogram``,
``stragglers``), in memory or out of core (``Trace.open(...,
streaming=True)``) — runs its reductions in hand-written Hopper kernels
(``repro_torch/csrc``) on the card unless the caller asks for the CPU
(``device="cpu"``), where the kernels' plain PyTorch versions run.
"""

from .core import EventFrame, Trace

__all__ = ["Trace", "EventFrame"]
