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

The logical axes name dimensions for the sharding rules
(:mod:`repro_torch.distributed.sharding`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed.sharding import is_dtensor

__all__ = ["ParamDef", "init_param", "init_tree", "abstract_tree",
           "map_defs", "is_def", "rms_norm", "rope", "apply_rope",
           "gelu", "swiglu_act", "softmax_xent"]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]       # logical axis name per dim
    init: str = "normal"                  # normal | zeros | ones
    scale: float = 1.0                    # stddev multiplier (normal)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


#: a normal parameter with more elements than this is drawn in row blocks
#: of at most ``_BLOCK`` elements (gemma3's 1.4 B-element embedding), so
#: that its float32 draw needs no second copy of it on the card
_HUGE = 1 << 30
_BLOCK = 1 << 27


def init_param(d: ParamDef, generator: torch.Generator,
               out: torch.Tensor) -> torch.Tensor:
    """Draw one parameter into ``out`` (of ``d``'s shape) from
    ``generator``, which lives on ``out``'s device type."""
    if d.init == "zeros":
        return out.zero_()
    if d.init == "ones":
        return out.fill_(1)
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    std = d.scale / max(fan_in, 1) ** 0.5
    n = out.numel()
    rows = d.shape[0] if n <= _HUGE else max(1, _BLOCK // (n // d.shape[0]))
    for i in range(0, d.shape[0], rows):
        blk = out[i:i + rows]
        x = torch.randn(blk.shape, generator=generator, dtype=torch.float32,
                        device=out.device)
        blk.copy_(x.mul_(std))
    return out


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def map_defs(fn: Callable[[ParamDef], Any], tree):
    """``tree`` (nested dicts, lists and tuples; None an empty subtree)
    with ``fn`` applied to each leaf, a ParamDef being one, as
    ``jax.tree_util.tree_map(fn, tree, is_leaf=is_def)`` does."""
    if isinstance(tree, dict):
        return {k: map_defs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_defs(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def init_tree(tree, key, dtype=torch.bfloat16, device="cuda"):
    """A ParamDef tree drawn into tensors on ``device``, leaf by leaf in
    the tree's order, each by :func:`init_param` from ``key`` (a
    ``torch.Generator`` on ``device``'s type, or an int seed for one).
    The reference splits a ``jax.random`` key per leaf, so the draws
    differ from its."""
    dev = torch.device(device)
    gen = key
    if not isinstance(key, torch.Generator):
        gen = torch.Generator(device=dev.type).manual_seed(int(key))
    return map_defs(lambda d: init_param(d, gen, torch.empty(
        d.shape, dtype=dtype, device=dev)), tree)


def abstract_tree(tree, dtype=torch.bfloat16):
    """Stand-ins for a ParamDef tree: tensors on the ``meta`` device, a
    shape and a dtype with no storage (the reference's
    ``ShapeDtypeStruct``)."""
    return map_defs(lambda d: torch.empty(d.shape, dtype=dtype,
                                          device="meta"), tree)


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


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation, as ``jax.nn.gelu(approximate=True)``."""
    return F.gelu(x, approximate="tanh")


def swiglu_act(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """Mean next-token cross-entropy in f32 (:func:`repro.models.layers.
    softmax_xent`): logits [B, S, V] (V possibly padded beyond ``vocab``),
    labels [B, S] int; a label ``>= vocab`` or ``< 0`` is masked out, and
    the mean is over the labels kept (at least one)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    keep = (labels >= 0) & (labels < vocab)
    idx = torch.where(keep, labels, 0).long()
    if is_dtensor(lf):
        # vocab-sharded logits: pick the label's logit by a masked sum, a
        # reduction each vocab shard does locally
        ids = torch.arange(lf.shape[-1], device=lf.device)
        ll = torch.where(ids == idx[..., None], lf, 0.0).sum(-1)
    else:
        ll = torch.gather(lf, -1, idx[..., None])[..., 0]
    nll = torch.where(keep, lse - ll, 0.0)
    return nll.sum() / torch.clamp_min(keep.sum(), 1)
