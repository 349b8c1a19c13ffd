"""The reference's first training steps: the loss, its gradient and
AdamW with decoupled weight decay and global-norm clipping, in float32
with TF32 off.  The parameters are stored in bfloat16 between steps, as
the configurations state (``torch_dtype``), while the moments and the
update stay in float32."""

from __future__ import annotations

import math
from typing import Dict, Iterable, List

import torch

from . import model as M


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def lr_at(step: int, opt: dict) -> float:
    """Linear warm-up to ``peak_lr`` over ``warmup_steps`` (step s takes
    (s + 1) / warmup of it), then a cosine down to a tenth at
    ``total_steps``; ``step`` counts from 0."""
    peak, warm, total = opt["peak_lr"], opt["warmup_steps"], \
        opt["total_steps"]
    if step < warm:
        return peak * min((step + 1) / max(warm, 1), 1.0)
    prog = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return peak * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * prog)))


def run_steps(blocks: Iterable, batches: List[Dict[str, torch.Tensor]],
              a: M.Arch, opt: dict, mm: M.Matmul = M.plain_mm,
              store_dtype=torch.bfloat16,
              sample: Dict[str, torch.Tensor] = None) -> dict:
    """``len(batches)`` steps from the weights in ``blocks`` (pairs of
    block name and {name: tensor}, as :mod:`cardbench.weights` draws
    them).  Returns each step's loss, each leaf's norm of the first
    (clipped) gradient and of the parameters' change after the last
    step, and the first gradient at the flat indices ``sample`` gives
    each leaf."""
    no_tf32()
    p0 = {}
    for _, leaves in blocks:
        p0.update(leaves)
    p = {k: v.float().requires_grad_(True) for k, v in p0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    losses, g1, g1s = [], {}, {}
    names = list(p)
    for s, batch in enumerate(batches):
        loss = M.loss(p, batch["tokens"], batch["labels"], a, mm)
        grads = torch.autograd.grad(loss, [p[k] for k in names])
        losses.append(float(loss.detach()))
        del loss
        gn = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads))
        scale = min(1.0, opt["clip_norm"] / max(float(gn), 1e-12)) \
            if opt.get("clip_norm") else 1.0
        lr = lr_at(s, opt)
        with torch.no_grad():
            for k, g in zip(names, grads):
                g = g * scale
                if s == 0:
                    g1[k] = float(torch.linalg.vector_norm(g))
                    if sample is not None:
                        g1s[k] = g.reshape(-1)[sample[k]].double().cpu() \
                            .numpy()
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (m[k] / (1 - b1 ** (s + 1))) / (
                    torch.sqrt(v2[k] / (1 - b2 ** (s + 1))) + eps) \
                    + wd * p[k]
                p[k].copy_((p[k] - lr * upd).to(store_dtype).float())
        del grads
    with torch.no_grad():
        delta = {k: float(torch.linalg.vector_norm(p[k] - p0[k].float()))
                 for k in names}
    return {"losses": losses, "grad_norms": g1, "delta_norms": delta,
            "grad_sample": g1s}
