"""Runtime of the port: the host-side tracer (mirrors :mod:`repro.runtime`;
the trainer waits for the training slice, ROADMAP §A)."""

from .tracer import Tracer

__all__ = ["Tracer"]
