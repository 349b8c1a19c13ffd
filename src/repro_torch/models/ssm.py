"""Mamba-2 SSD (state-space duality) core: the chunked parallel form for
prefill and training, the O(1)-state recurrent form for decode.

Mirrors :mod:`repro.models.ssm` (``ssd_reference``, ``ssd_chunked``,
``ssd_step``, ``causal_conv1d``, ``conv1d_step``).  Per head h, head dim
P, state N:

    h_t = exp(A·dt_t) · h_{t-1} + dt_t · B_t ⊗ x_t        (state update)
    y_t = C_t · h_t + D · x_t                             (readout)

Plain PyTorch: the state and every accumulation are float32, and an
explicit loop over chunks of ``Q`` tokens takes the place of the
reference's ``lax.scan`` (inside a chunk the quadratic form runs as
batched matmuls, between chunks the state is carried).  The chunk's
decay matrix masks its upper triangle before the exp, where the
reference masks after it: the forward is the same, and the gradient
stays finite where a chunk's decay passes f32's exp range (at full
width, training hymba-1.5b and mamba2-130m; ROADMAP §C).  The reference
computes this outside any Pallas kernel, so there is no kernel to port;
a hand-written SSD kernel would be a design change made against a
measured cost (ROADMAP §B).  The reference's seven activation
constraints stand at the same points (no-ops outside
:func:`repro_torch.distributed.sharding.activation_sharding`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed.sharding import constrain

__all__ = ["ssd_chunked", "ssd_reference", "ssd_step", "causal_conv1d",
           "conv1d_step"]


def ssd_reference(x, dt, A, Bm, Cm, h0: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential oracle.  x [B,S,H,P]; dt [B,S,H]; A [H]; Bm/Cm [B,S,N].
    Returns (y [B,S,H,P] in x's dtype, final state [B,H,P,N] f32)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    xf, dtf, bf, cf = x.float(), dt.float(), Bm.float(), Cm.float()
    ys = []
    for t in range(S):
        decay = torch.exp(A.float()[None] * dtf[:, t])            # [B,H]
        h = h * decay[..., None, None] + (
            dtf[:, t, :, None, None] * xf[:, t, ..., None]
            * bf[:, t, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", h, cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((B, 0, H, P))
    return y.to(x.dtype), h


def ssd_chunked(x, dt, A, Bm, Cm, *, chunk: int = 256,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.  Same arguments and returns as :func:`ssd_reference`."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    f32 = torch.float32
    xf, dtf, bf, cf = x.to(f32), dt.to(f32), Bm.to(f32), Cm.to(f32)
    if pad:
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        bf = F.pad(bf, (0, 0, 0, pad))
        cf = F.pad(cf, (0, 0, 0, pad))
    xf = constrain(xf, "act_batch", None, "act_ssm_heads", None)
    dtf = constrain(dtf, "act_batch", None, "act_ssm_heads")
    bf = constrain(bf, "act_batch", None, None)
    cf = constrain(cf, "act_batch", None, None)
    Af = A.to(f32)
    h = (torch.zeros((B, H, P, N), dtype=f32, device=x.device)
         if h0 is None else h0.to(f32))
    h = constrain(h, "act_batch", "act_ssm_heads", None, None)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))
    ys = []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        xq, dtq, bq, cq = xf[:, sl], dtf[:, sl], bf[:, sl], cf[:, sl]
        cum = torch.cumsum(Af[None, None] * dtq, dim=1)   # [B,Q,H] inclusive
        # intra-chunk: the quadratic form
        g = torch.einsum("bsn,btn->bst", cq, bq)                  # [B,Q,Q]
        ldiff = cum[:, :, None, :] - cum[:, None, :, :]          # [B,s,t,H]
        # masked before the exp: above the diagonal ldiff is a growing
        # positive sum, whose exp overflows past ~88, and the reference's
        # where(mask, exp(ldiff), 0) then back-propagates 0 * inf = NaN
        L = torch.exp(torch.where(causal[None, :, :, None], ldiff,
                                  float("-inf")))
        m = g[..., None] * L * dtq[:, None, :, :]                # [B,s,t,H]
        y = torch.einsum("bsth,bthp->bshp", m, xq)               # [B,Q,H,P]
        # inter-chunk: the carried state's contribution
        y = y + torch.einsum("bsn,bhpn,bsh->bshp", cq, h, torch.exp(cum))
        # state passing
        tot = cum[:, -1:, :]                                     # [B,1,H]
        w = dtq * torch.exp(tot - cum)                           # [B,Q,H]
        h_in = torch.einsum("btn,bthp,bth->bhpn", bq, xq, w)
        h = h * torch.exp(tot[:, 0])[:, :, None, None] + h_in
        h = constrain(h, "act_batch", "act_ssm_heads", None, None)
        ys.append(constrain(y, "act_batch", None, "act_ssm_heads", None))
    y = torch.cat(ys, dim=1)
    return y[:, :S].to(x.dtype), h


def ssd_step(h, xt, dtt, A, bt, ct) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step.  h [B,H,P,N] f32; xt [B,H,P]; dtt [B,H]; bt/ct
    [B,N].  Returns (new state, y [B,H,P] in xt's dtype)."""
    decay = torch.exp(A.float()[None] * dtt.float())
    h = h * decay[..., None, None] + (
        dtt.float()[..., None, None] * xt.float()[..., None]
        * bt.float()[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", h, ct.float())
    return h, y.to(xt.dtype)


def causal_conv1d(x, w, b) -> torch.Tensor:
    """Depthwise causal conv, then SiLU.  x [B,S,C]; w [W,C]; b [C]."""
    W = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(W):        # W is 4: a tiny static unroll
        y = y + xp[:, i:i + S].float() * w[i][None, None]
    return F.silu(y + b[None, None]).to(x.dtype)


def conv1d_step(conv_state, xt, w, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode-time conv.  conv_state [B,W-1,C]; xt [B,C] → (new_state,
    yt)."""
    window = torch.cat([conv_state, xt[:, None]], dim=1)        # [B,W,C]
    y = torch.einsum("bwc,wc->bc", window.float(), w.float()) + b[None]
    return window[:, 1:], F.silu(y).to(xt.dtype)
