"""Flash attention on the card: the LM's prefill attention.

Port of the TPU kernel :mod:`repro.kernels.flash_attention` (reached in
the reference through ``repro.kernels.ops.flash_attention_gqa``), in the
layout of :func:`repro.models.attention.chunked_attention`: q
``[B, Sq, H, D]``, k/v ``[B, Sk, KVH, D]`` with ``H = KVH * G``, out
``[B, Sq, H, D]`` in q's dtype.  On a CUDA tensor :func:`flash_attention`
launches the hand-written kernel in ``csrc/flash_attention.cu`` (the KV
head of query head h is ``h // G``, read in place); on a CPU tensor it
runs :func:`flash_attention_plain`, the chunked online-softmax scan of
``chunked_attention``.

Both scale the query in its own dtype before the f32 cast, as
``chunked_attention`` — the function the model calls — does; the Pallas
kernel scales after the cast, so in bf16 the two differ in the query's
last bit.  A row that sees no key at all has no defined output (each
version averages V over its own padded blocks).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import build

__all__ = ["flash_attention", "flash_attention_plain", "mask", "LAUNCHES"]

#: kernel launches since import (one per wrapper call that launches)
LAUNCHES = 0

_NEG = -1e30
_CHUNK = 1024             # KV chunk of the plain scan (chunked_attention's)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)


def mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
         window: Optional[int], prefix_len: int = 0) -> torch.Tensor:
    """[Sq, Sk] boolean allowed-mask from absolute positions
    (:func:`repro.models.attention._mask`): ``prefix_len`` keeps the first
    keys visible, causally, outside the window."""
    d = qpos[:, None] - kpos[None, :]
    m = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        m &= d >= 0
    if window is not None:
        m &= d < window
    if prefix_len:
        m |= (kpos < prefix_len)[None, :] & (d >= 0)
    return m


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None, prefix_len: int = 0,
                          q_offset: int = 0,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain version: the online-softmax scan over KV chunks of
    ``chunked_attention``, in f32 after the query is scaled in its dtype."""
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = scale or D ** -0.5
    chunk = min(_CHUNK, Sk)
    nk = -(-Sk // chunk)
    dev = q.device
    qq = (q.reshape(B, Sq, KVH, G, D) * scale).to(q.dtype).float()
    qpos = q_offset + torch.arange(Sq, device=dev)
    m = torch.full((B, KVH, G, Sq), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KVH, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KVH, G, Sq, D), dtype=torch.float32, device=dev)
    for ki in range(nk):
        kci = k[:, ki * chunk:(ki + 1) * chunk].float()
        vci = v[:, ki * chunk:(ki + 1) * chunk].float()
        n = kci.shape[1]
        if n < chunk:                      # zero-padded tail, as the scan
            kci = torch.nn.functional.pad(kci, (0, 0, 0, 0, 0, chunk - n))
            vci = torch.nn.functional.pad(vci, (0, 0, 0, 0, 0, chunk - n))
        s = torch.einsum("bqhgd,bchd->bhgqc", qq, kci)
        kpos = ki * chunk + torch.arange(chunk, device=dev)
        allow = mask(qpos, kpos, causal, window, prefix_len) & \
            (kpos < Sk)[None, :]
        s = torch.where(allow, s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhgqc,bchd->bhgqd", p, vci)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.movedim(3, 1).reshape(B, Sq, H, D).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    prefix_len: int = 0, q_offset: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q [B, Sq, H, D], k/v [B, Sk, KVH, D] (float32 or bfloat16, one
    dtype) → [B, Sq, H, D] in q's dtype."""
    global LAUNCHES
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q [B, Sq, H, D] and k/v "
                         f"[B, Sk, KVH, D] expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or KVH == 0 or H % KVH:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"fit q {tuple(q.shape)} (H must be a multiple "
                         f"of KVH)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: one dtype of float32 or "
                        f"bfloat16 expected, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v on different devices")
    if Sk == 0:
        raise ValueError("flash_attention: no keys (Sk = 0)")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     prefix_len=prefix_len,
                                     q_offset=q_offset, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: contiguous q, k, v expected")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in "
                         f"{_HEAD_DIMS}")
    if B > 65535 or H > 65535:
        raise ValueError(f"flash_attention: B = {B} or H = {H} above 65535")
    out = torch.empty_like(q)
    if B == 0 or Sq == 0:
        return out
    build.check(build.library().pipit_flash_attention(
        q.device.index or 0, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, Sq, Sk, H, KVH, D, _DTYPES[q.dtype], int(causal),
        int(window is not None), int(window or 0), int(prefix_len),
        int(q_offset), float(scale or D ** -0.5), build.stream_of(q)),
        "flash_attention")
    LAUNCHES += 1
    return out
