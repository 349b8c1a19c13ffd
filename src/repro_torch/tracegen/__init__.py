"""repro_torch.tracegen — seeded trace generators of the port (mirrors
:mod:`repro.tracegen`; this slice carries :func:`big_trace`)."""

from .big import big_events, big_trace

__all__ = ["big_trace", "big_events"]
