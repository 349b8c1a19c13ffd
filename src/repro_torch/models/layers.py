"""Shared neural-net layers and the parameter-definition machinery.

Mirrors :mod:`repro.models.layers`.  Parameters are declared once as
``ParamDef`` (shape, logical axes, init rule); :func:`init_param` draws one
from an explicit ``torch.Generator`` at the reference's rule: normal with
std ``scale / sqrt(fan_in)``, ``fan_in = shape[-2]`` (``shape[-1]`` for a
vector), drawn in float32 and cast.  The JAX package draws per-leaf
``jax.random`` keys, so the two packages' weights from one seed differ; the
tests carry the JAX weights across instead
(:func:`repro_torch.convert.params_from_jax`).  The port declares each
layer's parameters unstacked, so ``fan_in`` is that of the layer's own
matrix, as it is for every stacked matrix in the reference.

The logical axes only name dimensions here: the port has no sharding
rules yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["ParamDef", "init_param", "rms_norm", "rope", "apply_rope",
           "swiglu_act"]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]       # logical axis name per dim
    init: str = "normal"                  # normal | zeros | ones
    scale: float = 1.0                    # stddev multiplier (normal)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def init_param(d: ParamDef, generator: torch.Generator,
               dtype=torch.float32, device="cuda") -> torch.Tensor:
    """One parameter, drawn on ``device`` from ``generator`` (which must
    live on the same device type)."""
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    std = d.scale / max(fan_in, 1) ** 0.5
    x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (x * std).to(dtype)


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Normalise in float32, cast back, then scale by ``1 + gamma`` in the
    input dtype (the reference's cast order)."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * (1.0 + gamma.to(dt))


def rope(positions: torch.Tensor, head_dim: int,
         theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotary tables for integer positions [..., S] → cos, sin
    [..., S, hd/2] in float32."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, hd]; cos/sin: [B, S, hd/2] (or broadcastable)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype) if cos.dim() == 3 else cos
    s = sin[..., None, :].to(x.dtype) if sin.dim() == 3 else sin
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def swiglu_act(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up
