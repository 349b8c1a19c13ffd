"""Flash attention on the card: the LM's prefill attention.

Port of the TPU kernel :mod:`repro.kernels.flash_attention` (reached in
the reference through ``repro.kernels.ops.flash_attention_gqa``), in the
layout of :func:`repro.models.attention.chunked_attention`: q
``[B, Sq, H, D]``, k/v ``[B, Sk, KVH, D]`` with ``H = KVH * G``, out
``[B, Sq, H, D]`` in q's dtype.  On a CUDA tensor :func:`flash_attention`
launches one of the two hand-written kernels in ``csrc/flash_attention.cu``
(the KV head of query head h is ``h // G``, read in place), chosen by
:func:`variant` from the dtype and head dim alone:

- ``"wgmma"`` (bfloat16 at D = 64, 96 or 128, every served model's head
  dim): ``flash_wgmma``, both products on the tensor cores (``wgmma`` on
  TMA-fed, swizzled shared-memory tiles: 64-column blocks under 128-byte
  swizzle at D = 64 and 128, three 32-column blocks under 64-byte swizzle
  at D = 96, phi-3-vision's).  It rounds the softmax weights P to bfloat16
  before P·V, as every tensor-core flash kernel does; the row sums stay
  f32.  Held to the bf16 gate, 3e-2.
- ``"simt"`` (float32, and bfloat16 at D = 16 or 32): ``flash_fwd``, f32
  FMAs with P in f32, held to 2e-5 in float32.  Its bfloat16 instantiation
  at D = 64, 96 and 128 stays reachable through
  :func:`flash_attention_variant`, the yardstick the card's checks time
  the tensor-core kernel against.

On a CPU tensor it runs :func:`flash_attention_plain`, the chunked
online-softmax scan of ``chunked_attention`` (P in f32), which is
differentiable.  There is no fallback between the kernels: a CUDA call
launches its variant or raises.

Training: when grad mode is on and an input requires grad, a CUDA call
goes through an ``autograd.Function`` whose forward is the same kernel,
asked to write each row's log-sum-exp as well, and whose backward is
:func:`flash_attention_bwd`: the hand-written kernels of
``csrc/flash_attention_bwd.cu`` (no TPU counterpart: the reference's
Pallas kernel is forward-only and it trains by autodiff through
``chunked_attention``), chosen by :func:`variant_bwd` with the forward's
rule:

- ``"wgmma"`` (bfloat16 at D = 64, 96 or 128): ``bwd_dkdv_wgmma`` and
  ``bwd_dq_wgmma``, every product on the tensor cores, in the forward's
  tile layouts; P and dS are rounded to bfloat16 before the three gradient
  products.  Held to the bf16 gate, 3e-2 x each gradient's largest
  magnitude (``launch.cardcheck.flash_bwd_tol``).
- ``"simt"`` (float32, and bfloat16 at D = 16 or 32): ``bwd_dkdv`` and
  ``bwd_dq``, f32 FMAs, held to 2e-5 x that magnitude in float32;
  reachable in bfloat16 at every head dim through
  :func:`flash_attention_bwd_variant`.

:func:`flash_attention_bwd_plain` is their plain version.  Serving, under
``torch.no_grad()``, launches as before and writes no log-sum-exp.

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

__all__ = ["flash_attention", "flash_attention_plain",
           "flash_attention_variant", "flash_attention_bwd",
           "flash_attention_bwd_plain", "flash_attention_bwd_variant",
           "variant", "variant_bwd", "mask", "LAUNCHES", "VARIANT_LAUNCHES",
           "LAUNCHES_BWD", "VARIANT_LAUNCHES_BWD"]

#: kernel launches since import (one per wrapper call that launches)
LAUNCHES = 0
#: the same launches by kernel variant
VARIANT_LAUNCHES = {"simt": 0, "wgmma": 0}
#: backward-kernel launches since import (one per backward call on the
#: card: the three kernels of a variant of csrc/flash_attention_bwd.cu)
LAUNCHES_BWD = 0
#: the same launches by backward variant
VARIANT_LAUNCHES_BWD = {"simt": 0, "wgmma": 0}

_NEG = -1e30
_CHUNK = 1024             # KV chunk of the plain scan (chunked_attention's)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 96, 128)
_WGMMA_HEAD_DIMS = (64, 96, 128)
_VARIANT_IDS = {"simt": 0, "wgmma": 1}


def variant(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a CUDA call with this dtype and head dim launches:
    ``"wgmma"`` (tensor cores) for bfloat16 at D = 64, 96 or 128, else
    ``"simt"`` (f32 FMAs: float32 needs P in f32 to meet 2e-5, and the
    tensor-core tiles have no layout for D = 16 or 32, which no served
    model uses)."""
    if dtype == torch.bfloat16 and head_dim in _WGMMA_HEAD_DIMS:
        return "wgmma"
    return "simt"


def variant_bwd(dtype: torch.dtype, head_dim: int) -> str:
    """The backward kernel a CUDA call with this dtype and head dim
    launches, by :func:`variant`'s rule: ``"wgmma"`` (tensor cores) for
    bfloat16 at D = 64, 96 or 128, else ``"simt"``."""
    return variant(dtype, head_dim)


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
                          scale: Optional[float] = None,
                          return_lse: bool = False):
    """Plain version: the online-softmax scan over KV chunks of
    ``chunked_attention``, in f32 after the query is scaled in its dtype.
    With ``return_lse`` also each row's log-sum-exp ``m + log(max(l,
    1e-30))``, f32 ``[B, H, Sq]``, as the kernels write it for the
    backward."""
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
    den = torch.clamp_min(l, 1e-30)
    out = (acc / den[..., None]).movedim(3, 1).reshape(B, Sq, H, D).to(
        q.dtype)
    if return_lse:
        return out, (m + torch.log(den)).reshape(B, H, Sq)
    return out


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              do: torch.Tensor, lse: torch.Tensor, *,
                              causal: bool = True,
                              window: Optional[int] = None,
                              prefix_len: int = 0, q_offset: int = 0,
                              scale: Optional[float] = None):
    """Plain version of the backward kernel: from the forward's output
    ``o`` and row log-sum-exp ``lse`` ([B, H, Sq] f32) and the output's
    gradient ``do``, recompute ``P = exp(qq K^T - lse)`` under the mask
    (``qq = round(q * scale)`` in q's dtype, as the forward scales it), then
    ``dV = P^T dO``, ``dP = dO V^T``, ``Delta = rowsum(dO * O)``, ``dS =
    P (dP - Delta)``, ``dQ = scale dS K``, ``dK = dS^T qq``, in f32, summed
    over the G query heads of each KV head.  Returns (dq, dk, dv) in the
    inputs' dtype."""
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = scale or D ** -0.5
    dev = q.device
    qq = (q.reshape(B, Sq, KVH, G, D) * scale).to(q.dtype).float()
    kf, vf = k.float(), v.float()
    dof = do.reshape(B, Sq, KVH, G, D).float()
    qpos = q_offset + torch.arange(Sq, device=dev)
    allow = mask(qpos, torch.arange(Sk, device=dev), causal, window,
                 prefix_len)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qq, kf)
    p = torch.where(allow, torch.exp(s - lse.reshape(B, KVH, G, Sq, 1)),
                    0.0)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    delta = (dof * o.reshape(B, Sq, KVH, G, D).float()).sum(-1)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qq)
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    prefix_len: int = 0, q_offset: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q [B, Sq, H, D], k/v [B, Sk, KVH, D] (float32 or bfloat16, one
    dtype) → [B, Sq, H, D] in q's dtype; on the card through the kernel
    :func:`variant` picks."""
    return flash_attention_variant(
        variant(q.dtype, q.shape[-1]), q, k, v, causal=causal,
        window=window, prefix_len=prefix_len, q_offset=q_offset, scale=scale)


def flash_attention_variant(name: str, q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: Optional[int] = None, prefix_len: int = 0,
                            q_offset: int = 0,
                            scale: Optional[float] = None) -> torch.Tensor:
    """:func:`flash_attention` through the named kernel (``"simt"`` or
    ``"wgmma"``) whatever :func:`variant` would pick, to compare the two on
    the same inputs; a CPU tensor still runs the plain version."""
    if name not in _VARIANT_IDS:
        raise ValueError(f"flash_attention: unknown variant {name!r}")
    build.refuse_wrapped("flash_attention", q, k, v)
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
    if name == "wgmma":
        if q.dtype != torch.bfloat16 or D not in _WGMMA_HEAD_DIMS:
            raise ValueError(f"flash_attention: the wgmma kernel takes "
                             f"bfloat16 at D in {_WGMMA_HEAD_DIMS}, got "
                             f"{q.dtype} at D = {D}")
        if any(x.data_ptr() % 16 for x in (q, k, v)):
            raise ValueError("flash_attention: the wgmma kernel's TMA "
                             "loads need 16-byte aligned q, k, v")
    if B == 0 or Sq == 0:
        return torch.empty_like(q)
    cfg = _config(D, causal, window, prefix_len, q_offset, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Flash.apply(q, k, v, name, cfg)
    return _launch(name, q, k, v, cfg, want_lse=False)[0]


def _config(D: int, causal: bool = True, window: Optional[int] = None,
            prefix_len: int = 0, q_offset: int = 0,
            scale: Optional[float] = None) -> tuple:
    """The mask and scale a launch takes, as :func:`_launch` reads them."""
    return (causal, window, int(prefix_len), int(q_offset),
            float(scale or D ** -0.5))


def _launch(name: str, q, k, v, cfg, want_lse: bool):
    """One launch of the forward kernel ``name`` on checked CUDA inputs;
    returns (out, lse or None)."""
    global LAUNCHES
    causal, window, prefix_len, q_offset, scale = cfg
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    build.check(build.library().pipit_flash_attention(
        q.device.index or 0, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr() if want_lse else None, B, Sq, Sk, H,
        KVH, D, _DTYPES[q.dtype], _VARIANT_IDS[name], int(causal),
        int(window is not None), int(window or 0), prefix_len, q_offset,
        scale, build.stream_of(q)), f"flash_attention ({name})")
    with build.COUNT_LOCK:
        LAUNCHES += 1
        VARIANT_LAUNCHES[name] += 1
    return out, lse


class _Flash(torch.autograd.Function):
    """The kernel ``name`` forward (saving its output and row log-sum-exp)
    and :func:`flash_attention_bwd` backward, for CUDA inputs."""

    @staticmethod
    def forward(ctx, q, k, v, name, cfg):
        out, lse = _launch(name, q, k, v, cfg, want_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = cfg
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, prefix_len, q_offset, scale = ctx.cfg
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, do.contiguous(), lse, causal=causal,
            window=window, prefix_len=prefix_len, q_offset=q_offset,
            scale=scale)
        return dq, dk, dv, None, None


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        prefix_len: int = 0, q_offset: int = 0,
                        scale: Optional[float] = None):
    """The gradient of :func:`flash_attention`: q, o, do ``[B, Sq, H, D]``,
    k/v ``[B, Sk, KVH, D]`` (one dtype of float32 or bfloat16) and the
    forward's row log-sum-exp ``lse`` (f32 ``[B, H, Sq]``) → (dq, dk, dv)
    in the inputs' dtype; on the card through the backward kernel
    :func:`variant_bwd` picks (one launch of its three kernels), on a CPU
    tensor its plain version."""
    return flash_attention_bwd_variant(
        variant_bwd(q.dtype, q.shape[-1]), q, k, v, o, do, lse,
        causal=causal, window=window, prefix_len=prefix_len,
        q_offset=q_offset, scale=scale)


def flash_attention_bwd_variant(name: str, q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, o: torch.Tensor,
                                do: torch.Tensor, lse: torch.Tensor, *,
                                causal: bool = True,
                                window: Optional[int] = None,
                                prefix_len: int = 0, q_offset: int = 0,
                                scale: Optional[float] = None):
    """:func:`flash_attention_bwd` through the named kernel (``"simt"`` or
    ``"wgmma"``) whatever :func:`variant_bwd` would pick, to compare the
    two on the same inputs; a CPU tensor still runs the plain version.
    ``"wgmma"`` takes bfloat16 at D = 64, 96 or 128 only, and on the card
    16-byte aligned q, k, v and o (its TMA loads); an unaligned ``do``,
    which autograd hands over, is copied once instead."""
    global LAUNCHES_BWD
    if name not in _VARIANT_IDS:
        raise ValueError(f"flash_attention_bwd: unknown variant {name!r}")
    build.refuse_wrapped("flash_attention_bwd", q, k, v, o, do, lse)
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    if o.shape != q.shape or do.shape != q.shape or k.shape != v.shape or \
            tuple(lse.shape) != (B, H, Sq):
        raise ValueError(f"flash_attention_bwd: q/o/do {tuple(q.shape)}, "
                         f"{tuple(o.shape)}, {tuple(do.shape)}, k/v "
                         f"{tuple(k.shape)}, {tuple(v.shape)} and lse "
                         f"{tuple(lse.shape)} do not fit")
    if any(t.dtype != q.dtype for t in (k, v, o, do)) or \
            q.dtype not in _DTYPES or lse.dtype != torch.float32:
        raise TypeError("flash_attention_bwd: q, k, v, o, do of one dtype "
                        "(float32 or bfloat16) and an f32 lse expected")
    if name == "wgmma" and (q.dtype != torch.bfloat16 or
                            D not in _WGMMA_HEAD_DIMS):
        raise ValueError(f"flash_attention_bwd: the wgmma kernel takes "
                         f"bfloat16 at D in {_WGMMA_HEAD_DIMS}, got "
                         f"{q.dtype} at D = {D}")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(
            q, k, v, o, do, lse, causal=causal, window=window,
            prefix_len=prefix_len, q_offset=q_offset, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device "
                         f"{q.device}")
    ts = (q, k, v, o, do, lse)
    if any(t.device != q.device for t in ts) or \
            not all(t.is_contiguous() for t in ts):
        raise ValueError("flash_attention_bwd: contiguous inputs on one "
                         "device expected")
    if D not in _HEAD_DIMS or KVH == 0 or H % KVH or Sk == 0:
        raise ValueError(f"flash_attention_bwd: head dim {D} not in "
                         f"{_HEAD_DIMS}, or H = {H} not a multiple of "
                         f"KVH = {KVH}, or no keys")
    if B > 65535 or H > 65535:
        raise ValueError(f"flash_attention_bwd: B = {B} or H = {H} above "
                         f"65535")
    if name == "wgmma":
        if any(t.data_ptr() % 16 for t in (q, k, v, o)):
            raise ValueError("flash_attention_bwd: the wgmma kernel's TMA "
                             "loads need 16-byte aligned q, k, v, o")
        if do.data_ptr() % 16:
            do = do.clone()              # a fresh, aligned allocation
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if B == 0 or Sq == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    build.check(build.library().pipit_flash_attention_bwd(
        q.device.index or 0, *(t.data_ptr() for t in (
            q, k, v, o, do, lse, dq, dk, dv, delta)), B, Sq, Sk, H, KVH, D,
        _DTYPES[q.dtype], _VARIANT_IDS[name], int(causal),
        int(window is not None), int(window or 0), int(prefix_len),
        int(q_offset), float(scale or D ** -0.5), build.stream_of(q)),
        "flash_attention_bwd")
    with build.COUNT_LOCK:
        LAUNCHES_BWD += 1
        VARIANT_LAUNCHES_BWD[name] += 1
    return dq, dk, dv
