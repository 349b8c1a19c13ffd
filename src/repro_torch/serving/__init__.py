"""Serving layer of the port: the batch LM engine and the trace-query
service (mirrors :mod:`repro.serving`).

The service's modules (:mod:`~repro_torch.serving.tracequery`,
:mod:`~repro_torch.serving.client`, :mod:`~repro_torch.serving.protocol`)
load on first use, so importing the engine does not start an event loop
or import the service.
"""

from .engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine", "TraceService", "TraceServer",
           "ServiceClient"]


def __getattr__(name):
    if name in ("TraceService", "TraceServer"):
        from . import tracequery
        return getattr(tracequery, name)
    if name == "ServiceClient":
        from .client import ServiceClient
        return ServiceClient
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
