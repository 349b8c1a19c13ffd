"""Data pipeline of the port (mirrors :mod:`repro.data`)."""

from .synthetic import SyntheticLMStream

__all__ = ["SyntheticLMStream"]
