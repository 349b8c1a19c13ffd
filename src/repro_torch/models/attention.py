"""Attention cores: chunked (flash) prefill attention and single-token
decode attention.

Mirrors :mod:`repro.models.attention`.  :func:`chunked_attention` is the
function the model calls for prefill and training attention: on a CUDA
tensor it runs the hand-written kernel
:mod:`repro_torch.kernels.flash_attention`, on a CPU tensor that kernel's
plain version (the same online-softmax scan over KV chunks as the
reference).  :func:`decode_attention` stays plain PyTorch, as the
reference computes it outside any Pallas kernel.  The banded
``local_attention`` of sliding-window layers waits for the slice that
ports those layers (ROADMAP §A).

GQA layout: q ``[B,S,H,D]``, k/v ``[B,S,KVH,D]`` with ``H = KVH*G``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels import flash_attention as _flash

__all__ = ["reference_attention", "chunked_attention", "decode_attention"]

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
    ``flash_attention`` kernel's wrapper."""
    return _flash.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
        window=window, prefix_len=prefix_len, q_offset=q_offset,
        scale=scale)


def decode_attention(q, k, v, *, kv_len: int, window=None, scale=None):
    """Single-token attention against a full cache.

    q ``[B,1,H,D]``; k/v ``[B,Smax,KVH,D]`` where positions ``>= kv_len``
    are unwritten.  The score tensor is only ``[B,H,Smax]``.
    """
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
