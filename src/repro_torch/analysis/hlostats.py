"""Byte accounting of HLO shapes.

Mirrors the part of :mod:`repro.analysis.hlostats` that the HLO reader
(:mod:`repro_torch.readers.hlo`) uses: the bytes per element of each HLO
dtype and the size of a shape such as ``bf16[16,512]``.
"""

from __future__ import annotations

import re

__all__ = ["DTYPE_BYTES", "shape_bytes"]

DTYPE_BYTES = {
    "f64": 8, "s64": 8, "u64": 8, "c64": 8,
    "f32": 4, "s32": 4, "u32": 4,
    "bf16": 2, "f16": 2, "s16": 2, "u16": 2,
    "f8e4m3fn": 1, "f8e5m2": 1, "s8": 1, "u8": 1, "pred": 1,
}

_SHAPE_RE = re.compile(r"(\w+?)\[([\d,]*)\]")


def shape_bytes(shape_str: str) -> int:
    """'bf16[16,512]' → bytes (an unknown dtype counts 4 bytes)."""
    m = _SHAPE_RE.match(shape_str)
    if not m:
        return 0
    dt, dims = m.groups()
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * DTYPE_BYTES.get(dt, 4)
