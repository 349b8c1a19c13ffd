"""repro_torch.analysis — mirrors :mod:`repro.analysis`: byte and
collective accounting of HLO text (:mod:`.hlostats`), the dot inventory
(:mod:`.dots`) and the three-term roofline on the card's hardware table
(:mod:`.roofline`)."""

from .hlostats import DTYPE_BYTES, collective_stats, shape_bytes
from .roofline import HW, HW_H100, roofline_terms

__all__ = ["collective_stats", "shape_bytes", "DTYPE_BYTES",
           "roofline_terms", "HW", "HW_H100"]
