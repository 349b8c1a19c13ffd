"""repro_torch — the PyTorch + CUDA port of the Pipit reproduction.

A package of its own beside the JAX reference :mod:`repro`: it imports
``torch`` and ``numpy``, never ``jax`` and nothing of ``repro``.  The main
path — ``Trace.open`` → structure → the kernel-backed analysis ops
(``flat_profile``, ``time_profile``, ``load_imbalance``, ``comm_matrix``,
``message_histogram``) — runs its reductions in hand-written Hopper
kernels (``repro_torch/csrc``) on the card unless the caller asks for the
CPU (``device="cpu"``), where the kernels' plain PyTorch versions run.
"""

from .core import EventFrame, Trace

__all__ = ["Trace", "EventFrame"]
