"""Decoupled AdamW with f32 moments and global-norm clipping.

Mirrors :mod:`repro.optim.adamw`.  The reference maps over a pytree; the
port keeps parameters, gradients and moments as dicts keyed by the
model's ``state_dict`` names.  Gradients are taken as f32 (the trainer
accumulates them in f32 buffers), the norm for clipping is the global norm
over those f32 gradients, weight decay applies to every leaf as the
reference applies it, and the update runs in f32 and is cast back to the
parameter's dtype.  Unlike the reference, which returns new arrays, the
port updates the parameters and the moments in place: a step allocates
no second copy of the model or its state.  A large plain leaf is updated
in pieces of :data:`CHUNK` elements (every op is elementwise, so the bits
are the same): the update's f32 temporaries stay that size, where a
whole 1.4 B-element embedding (gemma3-27b's) would take 5.3 GiB each.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

__all__ = ["AdamWState", "adamw_init", "abstract_adamw_state",
           "adamw_update", "global_norm", "CHUNK"]

#: the most elements of one leaf :func:`adamw_update` updates at once
CHUNK = 1 << 26


@dataclasses.dataclass
class AdamWState:
    """``step`` (an int: updates taken so far) and the f32 moments ``m``
    and ``v``, one tensor per parameter name."""
    step: int
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def adamw_init(params: Dict[str, torch.Tensor]) -> AdamWState:
    """Zero moments in f32 on each parameter's device, step 0 (laid out
    as the parameter: a DTensor's moments are DTensors of its
    placements)."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32,
                                memory_format=torch.contiguous_format)
    return AdamWState(step=0, m={k: zeros(p) for k, p in params.items()},
                      v={k: zeros(p) for k, p in params.items()})


def abstract_adamw_state(abstract_params: Dict[str, torch.Tensor]
                         ) -> AdamWState:
    """The state :func:`adamw_init` would make, as ``meta``-device f32
    stand-ins of each parameter's shape (``LM.abstract_params``)."""
    def z():
        return {k: torch.empty(p.shape, dtype=torch.float32, device="meta")
                for k, p in abstract_params.items()}
    return AdamWState(step=0, m=z(), v=z())


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum, leaf by leaf in order, of each leaf's f32 sum of
    squares: a 0-d f32 tensor on the leaves' device."""
    total = None
    for g in tree.values():
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params: Dict[str, torch.Tensor],
                 grads: Dict[str, torch.Tensor], state: AdamWState, lr,
                 *, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 clip_norm: Optional[float] = 1.0) -> AdamWState:
    """One step on ``params`` (updated in place) from f32 ``grads``
    (scaled in place when clipping); ``lr`` a float or 0-d f32 tensor.
    Returns ``state`` with its step advanced and its moments updated in
    place."""
    step = state.step + 1
    dev = next(iter(params.values())).device
    if clip_norm is not None:
        gn = global_norm(grads)
        scale = torch.clamp_max(clip_norm / torch.clamp_min(gn, 1e-12), 1.0)
        for g in grads.values():
            g.mul_(scale)
    one = torch.ones((), dtype=torch.float32)
    bc1 = (1.0 - (b1 * one) ** float(step)).to(dev)
    bc2 = (1.0 - (b2 * one) ** float(step)).to(dev)
    lr = torch.as_tensor(lr, dtype=torch.float32).to(dev)
    for k, p in params.items():
        for p, g, m, v in _pieces(p, grads[k], state.m[k], state.v[k]):
            g = g.float()
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            pf = p.float()
            delta = (m / bc1) / (torch.sqrt(v / bc2) + eps) + \
                weight_decay * pf
            p.copy_((pf - lr * delta).to(p.dtype))
    state.step = step
    return state


def _pieces(p, g, m, v):
    """One leaf's (parameter, gradient, m, v) as flat views of at most
    :data:`CHUNK` elements; a small leaf, or a DTensor (whose shards the
    mesh lays out), whole."""
    from torch.distributed.tensor import DTensor
    n = p.numel()
    if n <= CHUNK or isinstance(p, DTensor):
        return [(p, g, m, v)]
    flat = (p.view(-1), g.reshape(-1), m.view(-1), v.view(-1))
    return [tuple(t[i:i + CHUNK] for t in flat) for i in range(0, n, CHUNK)]
