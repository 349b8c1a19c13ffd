"""Three-term roofline model on the port's card.

Mirrors :mod:`repro.analysis.roofline` (``roofline_terms``) with the
hardware table of the card the port runs on, an NVIDIA H100 SXM, per the
NVIDIA H100 Tensor Core GPU data sheet; the key names are the
reference's, which the HLO reader (:mod:`repro_torch.readers.hlo`) reads
too.

    compute term    = FLOPs       / (chips × peak)      [s]
    memory term     = HBM bytes   / (chips × HBM bw)    [s]
    collective term = wire_bytes  /  link bw            [s]  (wire bytes
                      are already per device, from the ring model)

``flops`` and ``hbm_bytes`` are whole-program totals (the sum over the
chips); the dominant term names the bottleneck, and model FLOPs over
program FLOPs exposes capacity and attention waste.  The numbers it gives
are a model, not a measurement.
"""

from __future__ import annotations

from typing import Dict, Optional

__all__ = ["HW", "HW_H100", "roofline_terms"]

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


def roofline_terms(flops: float, hbm_bytes: float, wire_bytes: float,
                   chips: int, model_flops: Optional[float] = None,
                   hw: Dict[str, float] = HW_H100) -> Dict[str, float]:
    t_compute = flops / chips / hw["peak_flops"]
    t_memory = hbm_bytes / chips / hw["hbm_bw"]
    t_collective = wire_bytes / hw["ici_bw"]
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_collective}
    dom = max(terms, key=terms.get)
    out = dict(terms)
    out["bottleneck"] = dom.replace("_s", "")
    out["step_time_s"] = max(terms.values())        # roofline lower bound
    out["chips"] = chips
    if model_flops:
        out["model_flops"] = model_flops
        out["useful_flop_frac"] = model_flops / max(flops, 1.0)
        out["mfu_bound"] = (model_flops / chips / hw["peak_flops"]
                            / max(out["step_time_s"], 1e-30))
    return out
