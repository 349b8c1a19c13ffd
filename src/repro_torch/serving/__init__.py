"""Serving layer of the port: the batch LM engine (mirrors
:mod:`repro.serving`; the trace-query service waits for its slice,
ROADMAP §A)."""

from .engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
