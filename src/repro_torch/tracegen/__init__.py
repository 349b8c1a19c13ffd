"""repro_torch.tracegen — seeded trace generators of the port (mirrors
:mod:`repro.tracegen`): :func:`big_trace` for the out-of-core routes, the
:class:`TraceBuilder`, the application-shaped generators of the paper's
case studies (:func:`gol`, :func:`stencil3d`, :func:`amg_vcycle`,
:func:`kripke_sweep`, :func:`tortuga`, :func:`loimos`,
:func:`axonn_training`, :func:`regression_pair`) and the ground-truth
pathology injection of the detector suite (:func:`baseline`,
:func:`inject`, :func:`pathology_trace`)."""

from .apps import (amg_vcycle, axonn_training, gol, kripke_sweep, loimos,
                   regression_pair, stencil3d, tortuga)
from .big import big_events, big_trace
from .builder import TraceBuilder
from .pathologies import (GroundTruth, PATHOLOGIES, baseline, inject,
                          pathology_trace)

__all__ = ["big_trace", "big_events", "TraceBuilder", "gol", "stencil3d",
           "amg_vcycle", "kripke_sweep", "tortuga", "loimos",
           "axonn_training", "regression_pair", "GroundTruth",
           "PATHOLOGIES", "baseline", "inject", "pathology_trace"]
