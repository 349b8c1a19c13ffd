"""Attention cores: chunked (flash) prefill attention, banded
sliding-window attention and single-token decode attention.

Mirrors :mod:`repro.models.attention`.  :func:`chunked_attention` (full,
or windowed with a visible prefix: Hymba's meta tokens) and
:func:`local_attention` (a causal sliding window: gemma3's local layers)
are the functions the model calls for prefill and training attention: on
a CUDA tensor both run the hand-written kernel
:mod:`repro_torch.kernels.flash_attention`, whose tile walk skips every
key tile wholly outside the window (``past_window`` in
``csrc/flash_mask.cuh``), on a CPU tensor that kernel's plain version (the
same online-softmax scan over KV chunks as the reference's
``chunked_attention``; the reference's banded scan gives the same
function).  :func:`decode_attention` stays plain PyTorch, as the reference
computes it outside any Pallas kernel.  Under a mesh (DTensor inputs
inside :func:`repro_torch.distributed.sharding.activation_sharding`) the
kernel is called on each rank's local shards (:func:`_sharded`): a
wrapper is never given a DTensor, nor, in the dry run, a fake tensor.

GQA layout: q ``[B,S,H,D]``, k/v ``[B,S,KVH,D]`` with ``H = KVH*G``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch._subclasses.fake_tensor import is_fake

from ..distributed import sharding
from ..distributed.sharding import constrain
from ..kernels import flash_attention as _flash

__all__ = ["reference_attention", "chunked_attention", "local_attention",
           "decode_attention"]

_NEG = -1e30
_mask = _flash.mask


def reference_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                        scale=None):
    """O(S²) oracle used by tests and tiny shapes."""
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = scale or D ** -0.5
    qq = q.reshape(B, Sq, KVH, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qq.float(), k.float()) * scale
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    s = torch.where(_mask(qpos, kpos, causal, window), s, _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


def chunked_attention(q, k, v, *, causal: bool = True,
                      window: Optional[int] = None, q_offset: int = 0,
                      scale: Optional[float] = None, prefix_len: int = 0):
    """Online-softmax attention over KV blocks (flash-style), through the
    ``flash_attention`` kernel's wrapper (DTensors: :func:`_sharded`)."""
    kw = dict(causal=causal, window=window, prefix_len=prefix_len,
              q_offset=q_offset, scale=scale)
    if sharding.is_dtensor(q):
        return _sharded(q, k, v, kw)
    return _flash_call(q.contiguous(), k.contiguous(), v.contiguous(), kw)


def _flash_call(q, k, v, kw):
    """The kernel's wrapper, or its plain version on fake tensors (the dry
    run is deviceless: nothing is launched or timed)."""
    if is_fake(q):
        return _flash.flash_attention_plain(q, k, v, **kw)
    return _flash.flash_attention(q, k, v, **kw)


def _sharded(q, k, v, kw):
    """Attention of DTensors under a mesh: q keeps its heads where the
    rules put them (``act_heads``, the model axis), K / V theirs
    (``act_kv``), both their batch on the data axes; each rank runs the
    kernel on its local shards.  Where the query heads shard and K / V do
    not (the GQA group spans ranks), a rank takes the KV heads of its own
    query heads, and their gradient is a partial sum over those ranks.
    The reference's online-softmax carry and its nine constraints live
    inside the local kernel call here; its four constraints on the inputs
    and the output stand."""
    from torch.distributed.tensor import Partial
    if sharding.active() is None:
        raise ValueError("attention of DTensors runs inside "
                         "activation_sharding(mesh, rules)")
    q = constrain(q, "act_batch", None, "act_heads", None)
    k = constrain(k, "act_batch", None, "act_kv", None)
    v = constrain(v, "act_batch", None, "act_kv", None)
    mesh = q.device_mesh
    if any(p.is_partial() for p in q.placements + k.placements):
        raise ValueError("attention: partial q or k/v after constrain")
    qh = [i for i, p in enumerate(q.placements) if p.is_shard(2)]
    kh = [i for i, p in enumerate(k.placements) if p.is_shard(2)]
    gp = [Partial() if i in qh and i not in kh else p
          for i, p in enumerate(k.placements)]
    ql = q.to_local()
    kl = k.to_local(grad_placements=gp)
    vl = v.to_local(grad_placements=gp)
    if kh != qh:
        if kh:
            raise ValueError(f"attention: K/V heads sharded on mesh dims "
                             f"{kh}, the query's on {qh}")
        H, KVH = q.shape[2], k.shape[2]
        G, Hl = H // KVH, ql.shape[2]
        if Hl % G and G % Hl:
            raise ValueError(f"attention: {Hl} local query heads split a "
                             f"GQA group of {G}")
        coord = mesh.get_coordinate()
        r = 0
        for i in qh:
            r = r * mesh.size(i) + coord[i]
        lo, hi = (r * Hl) // G, ((r + 1) * Hl - 1) // G + 1
        kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
    out = _flash_call(ql.contiguous(), kl.contiguous(), vl.contiguous(), kw)
    return constrain(sharding.from_local_like(out, q), "act_batch", None,
                     "act_heads", None)


def local_heads(fn, q, k, v):
    """``fn(q, k, v)`` of DTensors run on each rank's local shards (decode
    attention and the ring's, which run no kernel): the query's heads
    shard only where the KVH heads of K / V do, both their batch on the
    data axes, so each rank's query heads find their KV heads locally; a
    sharded cache sequence is gathered."""
    B, S, _H, D = q.shape
    KVH = k.shape[2]
    q = constrain(q, "act_batch", None, "act_kv", None,
                  shape=(B, S, KVH, D))
    k = constrain(k, "act_batch", None, "act_kv", None)
    v = constrain(v, "act_batch", None, "act_kv", None)
    if not (tuple(q.placements) == tuple(k.placements)
            == tuple(v.placements)):
        raise ValueError(f"attention: q {q.placements} and k/v "
                         f"{k.placements} do not split alike")
    return sharding.from_local_like(
        fn(q.to_local(), k.to_local(), v.to_local()), q)


def local_attention(q, k, v, *, window: int,
                    scale: Optional[float] = None):
    """Causal sliding-window self-attention: the query at position p sees
    the keys in ``(p - window, p]`` (sequences start at position 0),
    through the ``flash_attention`` kernel's wrapper."""
    if q.shape[1] != k.shape[1]:
        raise ValueError(f"local_attention is self-attention: Sq = "
                         f"{q.shape[1]}, Sk = {k.shape[1]}")
    return chunked_attention(q, k, v, causal=True, window=window,
                             scale=scale)


def decode_attention(q, k, v, *, kv_len: int, window=None, scale=None):
    """Single-token attention against a full cache.

    q ``[B,1,H,D]``; k/v ``[B,Smax,KVH,D]`` where positions ``>= kv_len``
    are unwritten.  The score tensor is only ``[B,H,Smax]``.
    """
    if sharding.is_dtensor(q):
        return local_heads(lambda a, b, c: decode_attention(
            a, b, c, kv_len=kv_len, window=window, scale=scale), q, k, v)
    B, _, H, D = q.shape
    Smax, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = scale or D ** -0.5
    qq = q.reshape(B, KVH, G, D) * scale
    s = torch.einsum("bhgd,bshd->bhgs", qq.float(), k.float())
    kpos = torch.arange(Smax, device=q.device)
    qpos = kv_len  # the new token's position
    allow = kpos < kv_len + 1
    allow &= kpos <= qpos
    if window is not None:
        allow &= kpos > qpos - window
    s = torch.where(allow, s, _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return o.reshape(B, 1, H, D).to(q.dtype)
