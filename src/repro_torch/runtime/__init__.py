"""Runtime of the port (mirrors :mod:`repro.runtime`): the host-side tracer
and the instrumented, fault-tolerant trainer."""

from .tracer import Tracer
from .trainer import FaultInjector, SimulatedFault, Trainer, TrainLoopConfig

__all__ = ["Tracer", "Trainer", "TrainLoopConfig", "FaultInjector",
           "SimulatedFault"]
