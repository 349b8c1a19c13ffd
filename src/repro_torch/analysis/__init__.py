"""repro_torch.analysis — the parts of :mod:`repro.analysis` the HLO
reader needs: byte accounting of HLO shapes (:mod:`.hlostats`) and the
card's hardware table (:mod:`.roofline`)."""

from .hlostats import DTYPE_BYTES, shape_bytes
from .roofline import HW, HW_H100

__all__ = ["DTYPE_BYTES", "shape_bytes", "HW", "HW_H100"]
