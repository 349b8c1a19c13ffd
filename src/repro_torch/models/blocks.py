"""Per-layer building blocks.

Mirrors :mod:`repro.models.blocks` for the layers of the serving slice: a
*layer spec* (``LayerSpec``) describes one transformer layer;
``layer_defs`` emits the ParamDefs of one layer, ``cache_defs`` its KV
cache, and ``layer_apply`` runs it in ``train`` / ``prefill`` / ``decode``
mode.  The slice covers the ``attn`` mixer with full causal (or
bidirectional) attention and a dense or MoE FFN, with shared experts and
their sigmoid gate.  Specs outside it — SSM and hybrid mixers,
cross-attention, sliding windows (``local_attention``, ring decode) and
meta tokens — raise ``NotImplementedError`` naming the ROADMAP item that
ports them.

Decode writes the new token's K/V into the cache in place (slot
``pos % Sc``), where the reference returns an updated copy.  The
reference's ``attn_broadcast_kv`` (repeat K/V to the query-head count, a
sharding aid) is dropped: the flash kernel reads a query head's KV head in
place, and the result is the same.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from . import attention as attn_lib
from .config import ModelConfig
from .layers import ParamDef, apply_rope, rms_norm, rope, swiglu_act
from .moe import moe_ffn

__all__ = ["LayerSpec", "layer_defs", "layer_apply", "cache_defs",
           "check_spec"]

_LATER = ("ROADMAP.md §A: local / window attention, meta tokens and ring "
          "decode (gemma3, hymba); ssm.py; encdec.py")


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str                    # attn | ssm | hybrid
    window: Optional[int] = None  # sliding window (None = full)
    moe: bool = False
    cross: bool = False           # enc-dec decoder cross-attention
    causal: bool = True
    rope_theta: Optional[float] = None


def check_spec(cfg: ModelConfig, spec: LayerSpec) -> None:
    """Raise for a layer the port does not run yet."""
    if spec.mixer != "attn":
        raise NotImplementedError(
            f"{spec.mixer!r} mixer not yet ported to repro_torch ({_LATER})")
    if spec.cross:
        raise NotImplementedError(
            f"cross-attention not yet ported to repro_torch ({_LATER})")
    if spec.window is not None or cfg.meta_tokens:
        raise NotImplementedError(
            f"sliding-window attention and meta tokens not yet ported to "
            f"repro_torch ({_LATER})")
    if not spec.moe and cfg.act != "swiglu":
        raise NotImplementedError(
            f"act={cfg.act!r} not yet ported to repro_torch (the slices "
            f"after the serving slice, ROADMAP.md §A)")


# ---------------------------------------------------------------------------
# parameter definitions
# ---------------------------------------------------------------------------

def _attn_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, H, KVH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    out = {
        "ln": ParamDef((d,), ("embed",), "zeros"),
        "wq": ParamDef((d, H * hd), ("embed", "heads")),
        "wk": ParamDef((d, KVH * hd), ("embed", "kv")),
        "wv": ParamDef((d, KVH * hd), ("embed", "kv")),
        "wo": ParamDef((H * hd, d), ("heads", "embed")),
    }
    if cfg.qkv_bias:
        out["bq"] = ParamDef((H * hd,), ("heads",), "zeros")
        out["bk"] = ParamDef((KVH * hd,), ("kv",), "zeros")
        out["bv"] = ParamDef((KVH * hd,), ("kv",), "zeros")
    return out


def _ffn_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, f = cfg.d_model, cfg.d_ff
    return {"fln": ParamDef((d,), ("embed",), "zeros"),
            "w_gate": ParamDef((d, f), ("embed", "mlp")),
            "w_up": ParamDef((d, f), ("embed", "mlp")),
            "w_down": ParamDef((f, d), ("mlp", "embed"))}


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
    out = _attn_defs(cfg)
    out.update(_moe_defs(cfg) if spec.moe else _ffn_defs(cfg))
    return out


def cache_defs(cfg: ModelConfig, spec: LayerSpec, batch: int,
               cache_len: int) -> Dict[str, ParamDef]:
    """KV cache ParamDefs for one layer at serve time: ``cache_len``
    slots."""
    check_spec(cfg, spec)
    KVH, hd = cfg.n_kv_heads, cfg.hd
    axes = ("batch", "kv_seq", "kv", None)
    return {"k_cache": ParamDef((batch, cache_len, KVH, hd), axes, "zeros"),
            "v_cache": ParamDef((batch, cache_len, KVH, hd), axes, "zeros")}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _attn_apply(p, x, cfg: ModelConfig, spec: LayerSpec, mode: str,
                pos: int, cache: Optional[dict], cache_len: int = 0):
    """Returns (out, new_cache_entries)."""
    B, S, d = x.shape
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    q = xn @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = q.reshape(B, S, H, hd)
    new_cache = {}
    theta = spec.rope_theta or cfg.rope_theta

    k = xn @ p["wk"]
    v = xn @ p["wv"]
    if "bk" in p:
        k = k + p["bk"]
        v = v + p["bv"]
    k = k.reshape(B, S, KVH, hd)
    v = v.reshape(B, S, KVH, hd)
    if spec.causal:                                   # rope on causal layers
        positions = pos + torch.arange(S, device=x.device)
        cos, sin = rope(positions[None], hd, theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    if mode == "decode":
        kc, vc = cache["k_cache"], cache["v_cache"]
        slot = pos % kc.shape[1]
        kc[:, slot:slot + 1] = k.to(kc.dtype)
        vc[:, slot:slot + 1] = v.to(vc.dtype)
        new_cache["k_cache"] = kc
        new_cache["v_cache"] = vc
        out = attn_lib.decode_attention(q, kc, vc, kv_len=pos)
    else:
        if mode == "prefill":
            new_cache["k_cache"] = _ring_layout(k, S, cache_len)
            new_cache["v_cache"] = _ring_layout(v, S, cache_len)
        out = attn_lib.chunked_attention(q, k, v, causal=spec.causal)
    y = out.reshape(B, S, H * hd) @ p["wo"]
    return y, new_cache


def _ring_layout(k: torch.Tensor, S: int, Sc: int) -> torch.Tensor:
    """Place prefill K/V of length S into an Sc-slot cache so that position
    p sits at slot ``p % Sc`` (the invariant the decode step keeps)."""
    if S >= Sc:
        return torch.roll(k[:, -Sc:], shifts=S % Sc, dims=1).contiguous()
    pad = torch.zeros((k.shape[0], Sc - S) + tuple(k.shape[2:]),
                      dtype=k.dtype, device=k.device)
    return torch.cat([k, pad], dim=1)


def _ffn_apply(p, x, cfg: ModelConfig, spec: LayerSpec, mode: str = "train"):
    xn = rms_norm(x, p["fln"], cfg.norm_eps)
    if spec.moe:
        B, S, d = xn.shape
        flat = xn.reshape(B * S, d)
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
        return y.reshape(B, S, d)
    h = swiglu_act(xn @ p["w_gate"], xn @ p["w_up"])
    return h @ p["w_down"]


def layer_apply(p: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: ModelConfig, spec: LayerSpec, mode: str = "train",
                pos: int = 0, cache: Optional[dict] = None,
                cache_len: int = 0):
    """One full layer.  Returns (x_out, new_cache_dict)."""
    check_spec(cfg, spec)
    y, new_cache = _attn_apply(p, x, cfg, spec, mode, pos, cache,
                               cache_len=cache_len)
    x = x + y
    x = x + _ffn_apply(p, x, cfg, spec, mode=mode)
    return x, new_cache
