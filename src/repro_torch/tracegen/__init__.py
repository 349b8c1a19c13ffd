"""repro_torch.tracegen — seeded trace generators of the port (mirrors
:mod:`repro.tracegen`): :func:`big_trace` for the out-of-core routes, the
:class:`TraceBuilder` and the ground-truth pathology injection of the
detector suite (:func:`baseline`, :func:`inject`, :func:`pathology_trace`)."""

from .big import big_events, big_trace
from .builder import TraceBuilder
from .pathologies import (GroundTruth, PATHOLOGIES, baseline, inject,
                          pathology_trace)

__all__ = ["big_trace", "big_events", "TraceBuilder", "GroundTruth",
           "PATHOLOGIES", "baseline", "inject", "pathology_trace"]
