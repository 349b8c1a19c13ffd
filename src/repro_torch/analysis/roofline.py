"""The hardware table of the port's roofline model.

Mirrors the ``HW`` table of :mod:`repro.analysis.roofline`, with the key
names the HLO reader (:mod:`repro_torch.readers.hlo`) reads, but for the
card the port runs on: an NVIDIA H100 SXM, per the NVIDIA H100 Tensor Core
GPU data sheet.  The three-term ``roofline_terms`` model is not ported
yet.
"""

from __future__ import annotations

__all__ = ["HW", "HW_H100"]

HW_H100 = {
    # bf16 tensor-core peak, dense (no sparsity), FLOP/s
    "peak_flops": 989e12,
    # HBM3 bandwidth, bytes/s
    "hbm_bw": 3.35e12,
    # NVLink 4: 900 GB/s in both directions together, 450 GB/s each way
    "ici_bw": 450e9,
}

#: the default table of the port's models
HW = HW_H100
