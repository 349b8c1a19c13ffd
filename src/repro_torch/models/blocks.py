"""Per-layer building blocks.

Mirrors :mod:`repro.models.blocks`: a *layer spec* (``LayerSpec``)
describes one layer (which mixer it uses: attention, the Mamba-2 SSD, or
both in parallel; its attention window; a dense or MoE FFN);
``layer_defs`` emits the ParamDefs of one layer, ``cache_defs`` its serve
cache, and ``layer_apply`` runs it in ``train`` / ``prefill`` / ``decode``
mode.  Covered: the ``attn``, ``ssm`` and ``hybrid`` mixers (``x + 0.5 *
(attention + SSD)``, Hymba), full or sliding-window causal attention with
always-visible meta tokens, bidirectional attention (the encoder's),
ring-buffer decode, the encoder-decoder's cross-attention, and a dense
(SwiGLU or GELU) or MoE FFN with shared experts and their sigmoid gate.

Cross-attention (``spec.cross``) follows the reference to its quirks: its
parameters carry an ``x_`` prefix; K and V are the encoder output times
``x_wk`` / ``x_wv`` without ``x_bk`` / ``x_bv`` (those two exist under
``qkv_bias`` but are never read, so their gradient is zero), and only
``x_bq`` is added; it is non-causal and takes no rope; prefill caches
its K / V (``x_k_cache``, ``x_v_cache``: ``[B, enc_frames, KVH, hd]``)
and every decode step reads them unchanged, through the flash kernel
like prefill (one query row against the encoder's frames).

Decode writes the new token's K/V into the cache in place (slot
``pos % Sc``), where the reference returns an updated copy.  The
reference's ``attn_broadcast_kv`` (repeat K/V to the query-head count
outside decode, a sharding aid that :func:`repro_torch.launch.steps.
build_cell` sets where neither KVH nor the group G divides the model axis
but H does) is kept: the result is the same, since the flash kernel
reads query head h's KV head ``h // G`` in place; the port broadcasts
after the prefill cache is written, so the cache keeps KVH heads, as
decode reads it.  The reference's
activation constraints (``constrain``) stand at the same points; they do
nothing outside :func:`repro_torch.distributed.sharding.
activation_sharding`.

One fault of the reference is repaired: its ``_merge_meta`` attends to
the meta tokens twice while their prefill positions are still in the
ring (``pos < min(window, cache_len) + meta_tokens - 1``); the port masks
ring slots whose position is below ``meta_tokens`` (ROADMAP §C).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..distributed.sharding import constrain, is_dtensor
from . import attention as attn_lib
from . import ssm as ssm_lib
from .config import ModelConfig
from .layers import ParamDef, apply_rope, gelu, rms_norm, rope, swiglu_act
from .moe import moe_ffn

__all__ = ["LayerSpec", "layer_defs", "layer_apply", "cache_defs",
           "check_spec"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str                    # attn | ssm | hybrid
    window: Optional[int] = None  # sliding window (None = full)
    moe: bool = False
    cross: bool = False           # enc-dec decoder cross-attention
    causal: bool = True
    rope_theta: Optional[float] = None


def check_spec(cfg: ModelConfig, spec: LayerSpec) -> None:
    """Raise for a layer no model runs: an unknown mixer."""
    if spec.mixer not in ("attn", "ssm", "hybrid"):
        raise ValueError(f"unknown mixer {spec.mixer!r}")


# ---------------------------------------------------------------------------
# parameter definitions
# ---------------------------------------------------------------------------

def _attn_defs(cfg: ModelConfig, prefix: str = "") -> Dict[str, ParamDef]:
    d, H, KVH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    out = {
        prefix + "ln": ParamDef((d,), ("embed",), "zeros"),
        prefix + "wq": ParamDef((d, H * hd), ("embed", "heads")),
        prefix + "wk": ParamDef((d, KVH * hd), ("embed", "kv")),
        prefix + "wv": ParamDef((d, KVH * hd), ("embed", "kv")),
        prefix + "wo": ParamDef((H * hd, d), ("heads", "embed")),
    }
    if cfg.qkv_bias:
        out[prefix + "bq"] = ParamDef((H * hd,), ("heads",), "zeros")
        out[prefix + "bk"] = ParamDef((KVH * hd,), ("kv",), "zeros")
        out[prefix + "bv"] = ParamDef((KVH * hd,), ("kv",), "zeros")
    return out


def _ssm_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    nh = d_in // cfg.ssm_headdim
    N = cfg.ssm_state
    conv_ch = d_in + 2 * N
    return {
        "sln": ParamDef((d,), ("embed",), "zeros"),
        "w_zx": ParamDef((d, 2 * d_in), ("embed", "ssm_in")),
        "w_bc": ParamDef((d, 2 * N), ("embed", None)),
        "w_dt": ParamDef((d, nh), ("embed", None)),
        "conv_w": ParamDef((cfg.conv_width, conv_ch), (None, "ssm_in")),
        "conv_b": ParamDef((conv_ch,), ("ssm_in",), "zeros"),
        "A_log": ParamDef((nh,), (None,), "zeros"),
        "Dskip": ParamDef((nh,), (None,), "ones"),
        "dt_bias": ParamDef((nh,), (None,), "zeros"),
        "w_so": ParamDef((d_in, d), ("ssm_in", "embed")),
    }


def _ffn_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    """SwiGLU: ``w_gate``, ``w_up``, ``w_down``; GELU: no ``w_gate``."""
    d, f = cfg.d_model, cfg.d_ff
    out = {"fln": ParamDef((d,), ("embed",), "zeros")}
    if cfg.act == "swiglu":
        out["w_gate"] = ParamDef((d, f), ("embed", "mlp"))
    out["w_up"] = ParamDef((d, f), ("embed", "mlp"))
    out["w_down"] = ParamDef((f, d), ("mlp", "embed"))
    return out


def _moe_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    out = {
        "fln": ParamDef((d,), ("embed",), "zeros"),
        "router": ParamDef((d, E), ("embed", None)),
        "we_gate": ParamDef((E, d, f), ("experts", "embed", "expert_mlp")),
        "we_up": ParamDef((E, d, f), ("experts", "embed", "expert_mlp")),
        "we_down": ParamDef((E, f, d), ("experts", "expert_mlp", "embed")),
    }
    if cfg.n_shared_experts:
        fs = cfg.moe_d_ff * cfg.n_shared_experts
        out["ws_gate"] = ParamDef((d, fs), ("embed", "mlp"))
        out["ws_up"] = ParamDef((d, fs), ("embed", "mlp"))
        out["ws_down"] = ParamDef((fs, d), ("mlp", "embed"))
        out["ws_sig"] = ParamDef((d, 1), ("embed", None), "zeros")
    return out


def layer_defs(cfg: ModelConfig, spec: LayerSpec) -> Dict[str, ParamDef]:
    check_spec(cfg, spec)
    out: Dict[str, ParamDef] = {}
    if spec.mixer in ("attn", "hybrid"):
        out.update(_attn_defs(cfg))
    if spec.mixer in ("ssm", "hybrid"):
        out.update(_ssm_defs(cfg))
    if spec.cross:
        out.update(_attn_defs(cfg, prefix="x_"))
    if spec.mixer != "ssm":                       # pure-SSM blocks have no FFN
        out.update(_moe_defs(cfg) if spec.moe else _ffn_defs(cfg))
    return out


def cache_defs(cfg: ModelConfig, spec: LayerSpec, batch: int,
               cache_len: int) -> Dict[str, ParamDef]:
    """Serve-cache ParamDefs for one layer (the reference's with
    ``ring=True``, the only form its model uses).  A sliding-window layer
    gets a ring of ``min(window, cache_len)`` slots, a full layer
    ``cache_len``; with meta tokens, their K/V apart (``k_meta``,
    ``v_meta``); an SSM layer its state ``ssm_h`` (kept in f32) and the
    last ``conv_width - 1`` conv inputs (``conv_state``); a decoder layer
    of the encoder-decoder its cross-attention's K / V over the encoder's
    frames (``x_k_cache``, ``x_v_cache``)."""
    check_spec(cfg, spec)
    out: Dict[str, ParamDef] = {}
    KVH, hd = cfg.n_kv_heads, cfg.hd
    if spec.mixer in ("attn", "hybrid"):
        S = min(spec.window, cache_len) if spec.window else cache_len
        axes = ("batch", "kv_seq", "kv", None)
        out["k_cache"] = ParamDef((batch, S, KVH, hd), axes, "zeros")
        out["v_cache"] = ParamDef((batch, S, KVH, hd), axes, "zeros")
        if cfg.meta_tokens:
            axes = ("batch", None, "kv", None)
            out["k_meta"] = ParamDef((batch, cfg.meta_tokens, KVH, hd),
                                     axes, "zeros")
            out["v_meta"] = ParamDef((batch, cfg.meta_tokens, KVH, hd),
                                     axes, "zeros")
    if spec.mixer in ("ssm", "hybrid"):
        d_in = cfg.ssm_expand * cfg.d_model
        nh = d_in // cfg.ssm_headdim
        out["ssm_h"] = ParamDef((batch, nh, cfg.ssm_headdim, cfg.ssm_state),
                                ("batch", None, None, None), "zeros")
        out["conv_state"] = ParamDef(
            (batch, cfg.conv_width - 1, d_in + 2 * cfg.ssm_state),
            ("batch", None, "ssm_in"), "zeros")
    if spec.cross:
        axes = ("batch", None, "kv", None)
        out["x_k_cache"] = ParamDef((batch, cfg.enc_frames, KVH, hd), axes,
                                    "zeros")
        out["x_v_cache"] = ParamDef((batch, cfg.enc_frames, KVH, hd), axes,
                                    "zeros")
    return out


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _attn_apply(p, x, cfg: ModelConfig, spec: LayerSpec, mode: str,
                pos: int, cache: Optional[dict], cache_len: int = 0):
    """Returns (out, new_cache_entries).  ``cache_len`` is the serve-time
    cache budget; a sliding-window layer keeps ``min(window, cache_len)``
    ring slots."""
    B, S, d = x.shape
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    M = cfg.meta_tokens
    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    q = xn @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = _heads(q, H, "act_heads")
    new_cache = {}
    theta = spec.rope_theta or cfg.rope_theta

    k = xn @ p["wk"]
    v = xn @ p["wv"]
    if "bk" in p:
        k = k + p["bk"]
        v = v + p["bv"]
    k = constrain(_heads(k, KVH, "act_kv"), "act_batch", "act_seq",
                  "act_kv", None)
    v = constrain(_heads(v, KVH, "act_kv"), "act_batch", "act_seq",
                  "act_kv", None)
    if spec.causal:                                   # rope on causal layers
        positions = pos + torch.arange(S, device=x.device)
        cos, sin = rope(positions[None], hd, theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    if mode == "decode":
        kc, vc = cache["k_cache"], cache["v_cache"]
        Sc = kc.shape[1]
        slot = pos % Sc
        kc[:, slot:slot + 1] = k.to(kc.dtype)
        vc[:, slot:slot + 1] = v.to(vc.dtype)
        new_cache["k_cache"] = kc
        new_cache["v_cache"] = vc
        if M and "k_meta" in cache:
            new_cache["k_meta"] = cache["k_meta"]
            new_cache["v_meta"] = cache["v_meta"]
            out = _merge_meta(q, cache["k_meta"], cache["v_meta"], kc, vc,
                              pos, Sc)
        elif spec.window and Sc <= spec.window:       # ring buffer: bounded
            out = _ring_decode(q, kc, vc, min(pos + 1, Sc))
        else:
            out = attn_lib.decode_attention(q, kc, vc, kv_len=pos,
                                            window=spec.window)
    else:
        if mode == "prefill":
            Sc = min(spec.window, cache_len) if spec.window else cache_len
            new_cache["k_cache"] = _ring_layout(k, S, Sc)
            new_cache["v_cache"] = _ring_layout(v, S, Sc)
            if M:
                new_cache["k_meta"] = k[:, :M].clone()
                new_cache["v_meta"] = v[:, :M].clone()
        if cfg.attn_broadcast_kv and KVH < H:
            # after the cache is written: it keeps KVH heads for decode
            k, v = _broadcast_kv(k, H // KVH), _broadcast_kv(v, H // KVH)
        if spec.window and not M:
            out = attn_lib.local_attention(q, k, v, window=spec.window)
        else:
            out = attn_lib.chunked_attention(q, k, v, causal=spec.causal,
                                             window=spec.window,
                                             prefix_len=M)
    y = constrain(_merge_heads(out, "act_heads") @ p["wo"], "act_batch",
                  "act_seq", "act_embed")
    return y, new_cache


def _broadcast_kv(k: torch.Tensor, G: int) -> torch.Tensor:
    """K or V repeated to the query-head count.  Under a mesh the repeat
    runs on replicated heads both ways (its backward sums each group of
    G, which a shard of the H heads cannot split); the attention then
    shards the H heads."""
    k = constrain(k, "act_batch", None, None, None)
    return constrain(torch.repeat_interleave(k, G, dim=2), "act_batch",
                     None, None, None)


def _heads(t: torch.Tensor, n: int, axis: str) -> torch.Tensor:
    """[..., n * hd] → [..., n, hd].  Under a mesh the merged dim first
    takes the layout ``axis`` gives n heads, so that the split keeps a
    shard only where n divides (a projection's output may come sharded
    by a factor n does not have)."""
    lead = tuple(t.shape[:-1])
    axes = ("act_batch",) + (None,) * (len(lead) - 1) + (axis,)
    t = constrain(t, *axes, shape=lead + (n,))
    return t.reshape(lead + (n, t.shape[-1] // n))


def _merge_heads(t: torch.Tensor, axis: str) -> torch.Tensor:
    """[..., n, hd] → [..., n * hd], the inverse of :func:`_heads`: under a
    mesh the merged dim keeps the layout ``axis`` gives n heads both ways,
    so the gradient's split back into heads never finds it sharded by a
    factor n does not have."""
    lead, n, hd = tuple(t.shape[:-2]), t.shape[-2], t.shape[-1]
    axes = ("act_batch",) + (None,) * (len(lead) - 1) + (axis,)
    return constrain(t.reshape(lead + (n * hd,)), *axes, shape=lead + (n,))


def _ring_layout(k: torch.Tensor, S: int, Sc: int) -> torch.Tensor:
    """Place prefill K/V of length S into an Sc-slot cache so that position
    p sits at slot ``p % Sc`` (the invariant the decode step keeps)."""
    if S >= Sc:
        return torch.roll(k[:, -Sc:], shifts=S % Sc, dims=1).contiguous()
    pad = torch.zeros((k.shape[0], Sc - S) + tuple(k.shape[2:]),
                      dtype=k.dtype, device=k.device)
    return torch.cat([k, pad], dim=1)


def _slot_positions(pos: int, Sc: int, device) -> torch.Tensor:
    """The position each of a ring's Sc slots holds after the token at
    ``pos`` was written (``p % Sc == slot``, the latest such ``p <= pos``);
    negative for a slot not written yet."""
    s = torch.arange(Sc, device=device)
    return pos - torch.remainder(pos - s, Sc)


def _ring_attend(q, k, v, valid) -> torch.Tensor:
    """One query token [B,1,H,D] over keys [B,T,KVH,D] where ``valid`` [T]
    holds, in f32 after the query is scaled in its dtype."""
    if is_dtensor(q):
        return attn_lib.local_heads(
            lambda a, b, c: _ring_attend(a, b, c, valid), q, k, v)
    B, _, H, D = q.shape
    KVH = k.shape[2]
    G = H // KVH
    qq = (q.reshape(B, KVH, G, D) * (D ** -0.5)).float()
    s = torch.einsum("bhgd,bshd->bhgs", qq, k.float())
    s = torch.where(valid, s, -1e30)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", w, v.float())
    return o.reshape(B, 1, H, D).to(q.dtype)


def _ring_decode(q, kc, vc, kv_len: int) -> torch.Tensor:
    """Attention over a ring buffer whose first ``kv_len`` slots are
    valid."""
    return _ring_attend(q, kc, vc,
                        torch.arange(kc.shape[1], device=q.device) < kv_len)


def _merge_meta(q, k_meta, v_meta, kc, vc, pos: int, Sc: int):
    """Decode attention over [meta ∪ ring], exactly as the full forward's
    mask (meta tokens always visible, the rest within the window): the
    meta K/V, then every ring slot holding a position at or above
    ``meta_tokens``.  The reference keeps every written slot, so while a
    meta position is still in the ring it is attended twice."""
    M = k_meta.shape[1]
    ring = _slot_positions(pos, Sc, q.device) >= M
    valid = torch.cat([torch.ones(M, dtype=torch.bool, device=q.device),
                       ring])
    return _ring_attend(q, torch.cat([k_meta, kc], dim=1),
                        torch.cat([v_meta, vc], dim=1), valid)


def _ssm_apply(p, x, cfg: ModelConfig, mode: str, cache: Optional[dict]):
    """The Mamba-2 mixer: in-projection, causal conv over (x, B, C), the
    SSD (chunked for a sequence, one recurrent step in decode), the D skip,
    the SiLU gate and the out-projection.  Returns (out, new_cache)."""
    B, S, d = x.shape
    d_in = cfg.ssm_expand * d
    P = cfg.ssm_headdim
    nh = d_in // P
    N = cfg.ssm_state
    xn = rms_norm(x, p["sln"], cfg.norm_eps)
    # whole along the features under a mesh, both ways: the slices below
    # cut across any shard of them
    zx = constrain(xn @ p["w_zx"], "act_batch", "act_seq", None)
    z, xin = zx[..., :d_in], zx[..., d_in:]
    bc = constrain(xn @ p["w_bc"], "act_batch", "act_seq", None)
    dt = F.softplus((xn @ p["w_dt"]).float() + p["dt_bias"].float())
    # per head, sharded only where the heads divide (a product's output
    # may come sharded by a factor nh does not have)
    dt = constrain(dt, "act_batch", None, "act_ssm_heads")
    A = -torch.exp(p["A_log"].float())
    xbc = torch.cat([xin, bc], dim=-1)
    new_cache = {}
    if mode == "decode":
        conv_state, yt = ssm_lib.conv1d_step(cache["conv_state"], xbc[:, 0],
                                             p["conv_w"], p["conv_b"])
        new_cache["conv_state"] = conv_state
        xs, Bm, Cm = yt[..., :d_in], yt[..., d_in:d_in + N], yt[..., d_in + N:]
        xs = _heads(xs, nh, "act_ssm_heads")
        h, y = ssm_lib.ssd_step(cache["ssm_h"], xs, dt[:, 0], A, Bm, Cm)
        new_cache["ssm_h"] = h
        y = _merge_heads(y, "act_ssm_heads")[:, None]
    else:
        yconv = ssm_lib.causal_conv1d(xbc, p["conv_w"], p["conv_b"])
        xs = _heads(yconv[..., :d_in], nh, "act_ssm_heads")
        Bm = yconv[..., d_in:d_in + N]
        Cm = yconv[..., d_in + N:]
        y, h = ssm_lib.ssd_chunked(xs, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
        if mode == "prefill":
            new_cache["ssm_h"] = h
            new_cache["conv_state"] = xbc[:, -(cfg.conv_width - 1):].clone()
        y = _merge_heads(y, "act_ssm_heads")
    y = y + _merge_heads(xs.reshape(B, -1, nh, P)
                         * p["Dskip"].to(x.dtype)[None, None, :, None],
                         "act_ssm_heads")
    y = y * F.silu(z)
    return y @ p["w_so"], new_cache


def _cross_apply(p, x, cfg: ModelConfig, mode: str, cache: Optional[dict],
                 enc_out: Optional[torch.Tensor]):
    """Cross-attention of a decoder layer over the encoder's output:
    (out, new_cache_entries).  In ``train`` and ``prefill`` K / V are
    ``enc_out`` times ``x_wk`` / ``x_wv`` (no ``x_bk`` / ``x_bv``, as the
    reference), and prefill caches them; ``decode`` reads the cached ones
    unchanged.  Non-causal, no rope."""
    B, S, _ = x.shape
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    xn = rms_norm(x, p["x_ln"], cfg.norm_eps)
    q = xn @ p["x_wq"]
    if "x_bq" in p:
        q = q + p["x_bq"]
    q = _heads(q, H, "act_heads")
    if mode == "decode":
        k, v = cache["x_k_cache"], cache["x_v_cache"]
    elif enc_out is None:
        raise ValueError(f"a cross-attention layer in {mode!r} mode needs "
                         f"the encoder's output (enc_out)")
    else:
        k = _heads(enc_out @ p["x_wk"], KVH, "act_kv")
        v = _heads(enc_out @ p["x_wv"], KVH, "act_kv")
    new_cache = {"x_k_cache": k, "x_v_cache": v} if mode != "train" else {}
    out = attn_lib.chunked_attention(q, k, v, causal=False)
    return _merge_heads(out, "act_heads") @ p["x_wo"], new_cache


def _ffn_apply(p, x, cfg: ModelConfig, spec: LayerSpec, mode: str = "train"):
    xn = rms_norm(x, p["fln"], cfg.norm_eps)
    if spec.moe:
        B, S, d = xn.shape
        # tokens on the data axes both ways: the gradient's reshape back
        # to [B, S, d] must not find them split over other axes too
        flat = constrain(xn.reshape(B * S, d), "act_batch", "act_embed")
        y = moe_ffn(flat, p["router"], p["we_gate"], p["we_up"],
                    p["we_down"], topk=cfg.topk,
                    capacity_factor=cfg.capacity_factor,
                    dropless=(mode == "decode"),
                    groups=1 if mode == "decode" else cfg.moe_groups)
        if "ws_gate" in p:
            shared = swiglu_act(flat @ p["ws_gate"],
                                flat @ p["ws_up"]) @ p["ws_down"]
            sig = torch.sigmoid((flat @ p["ws_sig"]).float())
            y = y + (shared.float() * sig).to(y.dtype)
        return constrain(y, "act_batch", "act_embed").reshape(B, S, d)
    def ff(w):               # each product in the hidden's layout, both ways
        return constrain(xn @ w, "act_batch", "act_seq", "act_ff")

    if cfg.act == "swiglu":
        h = swiglu_act(ff(p["w_gate"]), ff(p["w_up"]))
    else:
        h = gelu(ff(p["w_up"]))
    h = constrain(h, "act_batch", "act_seq", "act_ff")
    return constrain(h @ p["w_down"], "act_batch", "act_seq", "act_embed")


def layer_apply(p: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: ModelConfig, spec: LayerSpec, mode: str = "train",
                pos: int = 0, cache: Optional[dict] = None,
                enc_out: Optional[torch.Tensor] = None, cache_len: int = 0):
    """One full layer.  Returns (x_out, new_cache_dict).  ``enc_out``: the
    encoder's output, which a cross-attention layer attends to outside
    decode."""
    check_spec(cfg, spec)
    new_cache: Dict[str, torch.Tensor] = {}
    if spec.mixer == "attn":
        y, nc = _attn_apply(p, x, cfg, spec, mode, pos, cache,
                            cache_len=cache_len)
        new_cache.update(nc)
        x = x + y
    elif spec.mixer == "ssm":
        y, nc = _ssm_apply(p, x, cfg, mode, cache)
        new_cache.update(nc)
        x = x + y
    else:                                             # hybrid: in parallel
        ya, nca = _attn_apply(p, x, cfg, spec, mode, pos, cache,
                              cache_len=cache_len)
        ys, ncs = _ssm_apply(p, x, cfg, mode, cache)
        new_cache.update(nca)
        new_cache.update(ncs)
        x = x + 0.5 * (ya + ys)
    if spec.cross:
        y, nc = _cross_apply(p, x, cfg, mode, cache, enc_out)
        new_cache.update(nc)
        x = x + y
    if spec.mixer != "ssm":
        x = x + _ffn_apply(p, x, cfg, spec, mode=mode)
    return x, new_cache
