"""Mixture-of-Experts FFN with static-capacity gather/scatter dispatch.

Mirrors :mod:`repro.models.moe` (Switch-Transformer routing):

1. router logits → top-k experts + gate probs per token, on the card in
   one launch of the fused ``router_topk`` kernel (bfloat16; other dtypes
   take the float32 product and the ``topk_gating`` kernel); in training
   the gates' gradient comes back through one launch of
   ``topk_gating_bwd`` (either route) on the columns the forward chose,
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

Under a mesh (a DTensor ``x``), :func:`_moe_sharded` keeps the
reference's nine activation constraints; outside one, ``moe_ffn`` runs
as before, on plain tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..distributed.sharding import constrain, is_dtensor
from ..kernels import router_topk as _router
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
    """x [T, d]; router [d, E]; w_gate/w_up [E, d, f]; w_down [E, f, d].
    A DTensor ``x`` (under a mesh) takes :func:`_moe_sharded`."""
    T, d = x.shape
    E = w_gate.shape[0]
    G = groups if T % groups == 0 else 1
    Tg = T // G
    C = capacity(Tg, topk, E, capacity_factor, dropless)
    if is_dtensor(x):
        return _moe_sharded(x, w_router, w_gate, w_up, w_down, topk, G, Tg,
                            C)

    xg = x.reshape(G, Tg, d)
    # routing is per token, so the groups do not change it
    _logits, idx, gates = _route(x, w_router, topk)
    tok_tab, slot_of, gate_of = _dispatch(idx, gates, G, Tg, E, C, topk)
    xe = _gather(xg, tok_tab).reshape(G, E, C, d)

    h = torch.einsum("gecd,edf->gecf", xe, w_gate)
    u = torch.einsum("gecd,edf->gecf", xe, w_up)
    # each [G, E, C, ·] temporary is dropped once read: dropless (a
    # serving decode, or a large capacity factor) makes them the largest
    # tensors of a forward
    del xe
    act = F.silu(h) * u
    del h, u
    y = torch.einsum("gecf,efd->gecd", act, w_down)
    del act
    yp = torch.cat([y.reshape(G, E * C, d),
                    torch.zeros((G, 1, d), dtype=y.dtype, device=x.device)],
                   dim=1)
    del y
    return _combine(yp, slot_of, gate_of, x.dtype).reshape(T, d).to(x.dtype)


def _route(x, w_router, topk):
    """The router: the fused kernel's wrapper, or its plain version on fake
    tensors (the dry run is deviceless: nothing is launched)."""
    if _is_fake(x):
        return _router.router_topk_plain(x, w_router, topk)
    return _router.router_topk(x, w_router, topk)


def _dispatch(idx, gates, G: int, Tg: int, E: int, C: int, topk: int):
    """Per group: the token table of the [E*C] expert slots (``Tg`` where a
    slot is empty), and each token's ≤ k slots in slot order with their
    gates (the overflow slot ``E*C`` for a dropped assignment)."""
    dev = idx.device
    idx, gates = idx.reshape(G, Tg, topk), gates.reshape(G, Tg, topk)
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
    slot_of = torch.empty_like(slot).scatter_(1, order, slot)
    slot_of, by_slot = torch.sort(slot_of.reshape(G, Tg, topk), dim=-1)
    gate_of = torch.gather(flat_g.reshape(G, Tg, topk), 2, by_slot)
    return tok_tab[:, :-1], slot_of, gate_of


def _gather(xg, tok_tab):
    """[G, Tg, d] tokens → [G, E*C, d] in slot order (a zero row for an
    empty slot)."""
    G, _Tg, d = xg.shape
    xp = torch.cat([xg, torch.zeros((G, 1, d), dtype=xg.dtype,
                                    device=xg.device)], dim=1)
    return torch.gather(xp, 1, tok_tab[..., None].expand(G, -1, d))


def _combine(yp, slot_of, gate_of, cdt):
    """Combine in the activation dtype ``cdt``: each token's assignments,
    read back from its slots of ``yp`` [G, E*C + 1, d] (the overflow slot
    a zero row), weighted by their gates and added in slot order."""
    G, Tg, topk = slot_of.shape
    d = yp.shape[-1]
    out = torch.zeros((G, Tg, d), dtype=cdt, device=yp.device)
    for j in range(topk):
        yj = torch.gather(yp, 1, slot_of[..., j, None].expand(G, Tg, d))
        out = out + (yj.float() * gate_of[..., j, None]).to(cdt)
    return out


def _moe_sharded(x, w_router, w_gate, w_up, w_down, topk: int, G: int,
                 Tg: int, C: int):
    """:func:`moe_ffn` of a DTensor ``x`` at the reference's nine
    activation constraints: the token groups stay on the data axes
    (``build_cell`` sets ``moe_groups`` to their count), so routing and
    dispatch run on each rank's own groups, the router kernel on its local
    tokens and the whole router weight; the expert products run as DTensor
    ops with the experts (or their hidden dim) on ``model``; each rank
    combines its own experts' outputs into its tokens, and one all-reduce
    over the expert axis adds the ranks' partial sums (the reference's
    combine by a local scatter-add and one model-axis all-reduce, whose
    ``yw`` and ``zeros`` constraints fall away with it: the combine runs
    on local tensors and its all-reduce is the ``out`` constraint)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    T, d = x.shape
    E = w_gate.shape[0]
    xg = constrain(x.reshape(G, Tg, d), "act_batch", None, None)
    mesh, pl = xg.device_mesh, xg.placements

    def wrap(t, placements=pl):
        return DTensor.from_local(t, mesh, placements, run_check=False)

    xl = xg.to_local()
    Gl = xl.shape[0]
    # each data rank's router gradient covers its own tokens: partial sums
    # (the router's backward, on the card or the CPU, gives x^T @ dlogits
    # over this rank's tokens alone: the rank's share)
    wr = w_router.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Partial() if p.is_shard() else Replicate()
                         for p in pl])
    _logits, idx, gates = _route(xl.reshape(Gl * Tg, d), wr, topk)
    tok_tab, slot_of, gate_of = _dispatch(idx, gates, Gl, Tg, E, C, topk)
    xp = constrain(wrap(torch.cat([xl, torch.zeros(
        (Gl, 1, d), dtype=xl.dtype, device=xl.device)], dim=1)),
        "act_batch", None, None).to_local()
    xe = torch.gather(xp, 1, tok_tab[..., None].expand(Gl, -1, d))
    xe = constrain(wrap(xe.reshape(Gl, E, C, d)), "act_batch", "act_exp",
                   None, None)
    h = constrain(torch.einsum("gecd,edf->gecf", xe, w_gate),
                  "act_batch", "act_exp", None, "act_ff")
    u = constrain(torch.einsum("gecd,edf->gecf", xe, w_up),
                  "act_batch", "act_exp", None, "act_ff")
    del xe
    y = constrain(torch.einsum("gecf,efd->gecd", F.silu(h) * u, w_down),
                  "act_batch", "act_exp", None, None)
    del h, u
    # this rank's experts [e0, e0 + El): their slots, the rest to the zero
    # row, so the local combine is this rank's share of every token
    ex = [i for i, p in enumerate(y.placements) if p.is_shard(1)]
    coord = mesh.get_coordinate()
    yl = y.to_local()
    El = yl.shape[1]
    r = 0
    for i in ex:
        r = r * mesh.size(i) + coord[i]
    lo = r * El * C
    mine = (slot_of >= lo) & (slot_of < lo + El * C)
    slot_l = torch.where(mine, slot_of - lo, El * C)
    yp = torch.cat([yl.reshape(Gl, El * C, d), torch.zeros(
        (Gl, 1, d), dtype=yl.dtype, device=yl.device)], dim=1)
    # the gates' gradient from this rank's experts alone: a partial sum
    gate_of = wrap(gate_of).to_local(grad_placements=[
        Partial() if i in ex else p for i, p in enumerate(pl)])
    out = _PartialSum.apply(_combine(yp, slot_l, gate_of, x.dtype), mesh,
                            tuple(Partial() if i in ex else p
                                  for i, p in enumerate(pl)), tuple(pl))
    out = constrain(out, "act_batch", None, None)
    return out.reshape(T, d)


class _PartialSum(torch.autograd.Function):
    """Each rank's partial sum (a plain tensor) → the DTensor of their sum
    over the mesh dims ``partial`` marks, laid out as ``want``.  Backward:
    each rank takes the (replicated) gradient of the sum as its own
    (``from_local``'s backward would instead turn it back into a partial
    one, a share on one rank and zeros on the others)."""

    @staticmethod
    def forward(ctx, t, mesh, partial, want):
        from torch.distributed.tensor import DTensor
        ctx.mesh, ctx.want = mesh, want
        return DTensor.from_local(t, mesh, partial,
                                  run_check=False).redistribute(mesh, want)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.want).to_local(), None, None, \
            None


def _is_fake(x) -> bool:
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(x)
