"""Mixture-of-Experts FFN with static-capacity gather/scatter dispatch.

Mirrors :mod:`repro.models.moe` (Switch-Transformer routing):

1. router logits → top-k experts + gate probs per token, through the
   hand-written ``topk_gating`` kernel (:func:`route_topk`),
2. assignments stably sorted by expert id; rank within expert computed
   vectorially,
3. assignments over ``capacity`` are dropped (``capacity_factor``),
4. an index table gathers tokens into ``[G, E, C, d]``,
5. batched expert matmuls,
6. a gate-weighted combine back to token order.

``groups=G > 1`` dispatches G token groups independently.  Two choices of
the port: the table writes to the overflow slot ``E*C`` collide by design
and the slot is cut off, so the scatter that builds the table may land
its duplicate writes in any order; and the combine gathers each token's
≤ k expert outputs and adds them in slot (expert) order, the order of the
reference's scatter-add, instead of a float scatter-add whose order on
the card changes from run to run.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..kernels import topk_gating as _topk

__all__ = ["moe_ffn", "route_topk", "capacity"]


def route_topk(router_logits: torch.Tensor,
               topk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., E] float32 logits → ([..., k] int32 expert ids, [..., k]
    float32 gates)."""
    lead, E = router_logits.shape[:-1], router_logits.shape[-1]
    idx, gates = _topk.topk_gating(
        router_logits.reshape(-1, E).float().contiguous(), topk)
    return idx.reshape(*lead, topk), gates.reshape(*lead, topk)


def capacity(Tg: int, topk: int, n_experts: int, capacity_factor: float,
             dropless: bool) -> int:
    """Slots per expert and group: ``ceil8(int(Tg*k/E*cf))`` capped at
    ``Tg``, or ``Tg`` when dropless."""
    if dropless:
        return Tg
    C = max(int(Tg * topk / n_experts * capacity_factor), 1)
    C = -(-C // 8) * 8                       # lane-align capacity
    return min(C, Tg)


def moe_ffn(x: torch.Tensor, w_router: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, *, topk: int,
            capacity_factor: float = 1.25, dropless: bool = False,
            groups: int = 1) -> torch.Tensor:
    """x [T, d]; router [d, E]; w_gate/w_up [E, d, f]; w_down [E, f, d]."""
    T, d = x.shape
    E = w_gate.shape[0]
    G = groups if T % groups == 0 else 1
    Tg = T // G
    C = capacity(Tg, topk, E, capacity_factor, dropless)
    dev = x.device

    xg = x.reshape(G, Tg, d)
    logits = torch.einsum("gtd,de->gte", xg.float(), w_router.float())
    idx, gates = route_topk(logits, topk)                 # [G,Tg,k]

    K = Tg * topk
    flat_e = idx.reshape(G, K).long()
    flat_g = gates.reshape(G, K)
    flat_tok = torch.arange(Tg, device=dev).repeat_interleave(topk)
    flat_tok = flat_tok[None].expand(G, K)

    order = torch.argsort(flat_e, dim=1, stable=True)
    e_sorted = torch.gather(flat_e, 1, order)
    # rank within (group, expert): exclusive prefix of per-expert counts
    counts = torch.zeros((G, E), dtype=torch.long, device=dev)
    counts.scatter_add_(1, e_sorted, torch.ones_like(e_sorted))
    starts = torch.cumsum(counts, dim=1) - counts
    rank = torch.arange(K, device=dev)[None] - torch.gather(starts, 1,
                                                            e_sorted)
    keep = rank < C
    slot = torch.where(keep, e_sorted * C + rank,
                       torch.full_like(rank, E * C))      # overflow slot
    tok_sorted = torch.gather(flat_tok, 1, order)
    tok_tab = torch.full((G, E * C + 1), Tg, dtype=torch.long, device=dev)
    tok_tab.scatter_(1, slot, tok_sorted)
    tok_tab = tok_tab[:, :-1]

    xp = torch.cat([xg, torch.zeros((G, 1, d), dtype=x.dtype, device=dev)],
                   dim=1)
    xe = torch.gather(xp, 1, tok_tab[..., None].expand(G, E * C, d))
    xe = xe.reshape(G, E, C, d)

    h = torch.einsum("gecd,edf->gecf", xe, w_gate)
    u = torch.einsum("gecd,edf->gecf", xe, w_up)
    y = torch.einsum("gecf,efd->gecd", F.silu(h) * u, w_down)

    # combine in the activation dtype: each token's assignments, read back
    # from its slots (the overflow slot is a zero row), weighted by their
    # gates and added in slot order
    cdt = x.dtype
    slot_of = torch.empty_like(slot).scatter_(1, order, slot)
    slot_of, by_slot = torch.sort(slot_of.reshape(G, Tg, topk), dim=-1)
    gate_of = torch.gather(flat_g.reshape(G, Tg, topk), 2, by_slot)
    yp = torch.cat([y.reshape(G, E * C, d),
                    torch.zeros((G, 1, d), dtype=y.dtype, device=dev)],
                   dim=1)
    out = torch.zeros((G, Tg, d), dtype=cdt, device=dev)
    for j in range(topk):
        yj = torch.gather(yp, 1, slot_of[..., j, None].expand(G, Tg, d))
        out = out + (yj.float() * gate_of[..., j, None]).to(cdt)
    return out.reshape(T, d).to(x.dtype)
