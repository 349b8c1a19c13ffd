"""Model configuration: the one dataclass every architecture fills in.

A copy of :mod:`repro.models.config` (``ModelConfig``, ``pad_vocab``) for
the port, which imports nothing of the JAX package.  The fields of every
family are kept, so a config reads the same in both packages; the port's
model code interprets the ones its slices cover and refuses the rest.
The dry-run shapes (``ShapeConfig``, ``SHAPES``) are not copied.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ModelConfig", "pad_vocab"]


def pad_vocab(v: int, multiple: int = 256) -> int:
    """Pad vocab to a multiple (Megatron-style) so the vocab axis shards."""
    return ((v + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None            # default d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1e6

    # attention pattern
    window: Optional[int] = None               # sliding-window size (local attn)
    global_every: Optional[int] = None         # gemma3: 1 global per N layers
    causal: bool = True
    # broadcast KV to the query-head count before attention: when KVH and the
    # per-KV group G both fail to divide the TP axis but H does (qwen1.5-110b:
    # 8×8 vs 16), this is the only way the attention activations shard
    attn_broadcast_kv: bool = False

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    topk: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_groups: int = 1          # grouped dispatch (= data-shard count)

    # SSM (Mamba-2 / SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4

    # encoder-decoder (Whisper)
    enc_layers: int = 0
    enc_frames: int = 1500

    # VLM / hybrid extras
    img_tokens: int = 0                        # prepended patch embeddings
    meta_tokens: int = 0                       # Hymba learnable prefix

    # numerics
    norm_eps: float = 1e-6
    act: str = "swiglu"                        # swiglu | gelu
    dtype: str = "bfloat16"
    remat: str = "nothing_saveable"            # remat policy name

    # cost-probe mode (dry-run only): XLA's cost model counts a scan body
    # once regardless of trip count, so FLOP/byte/collective accounting needs
    # probes with *unrolled* scans.  0 = normal; 1/2 = inner scans fully
    # unrolled with the layer scan unrolled 1×/2× (see launch/dryrun.py).
    cost_probe: int = 0

    # ----------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab)

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch serve a 500k-token context with a bounded cache?"""
        return self.family in ("ssm", "hybrid") or (
            self.window is not None and self.global_every is not None)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for 6ND math."""
        d, V = self.d_model, self.padded_vocab
        hd = self.hd
        emb = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        # attention (absent for ssm family)
        if self.family != "ssm":
            qo = d * self.n_heads * hd * 2
            kv = d * self.n_kv_heads * hd * 2
            per_layer += qo + kv
        if self.family in ("ssm", "hybrid"):
            d_in = self.ssm_expand * self.d_model
            nh = d_in // self.ssm_headdim
            per_layer += d * (2 * d_in + 2 * self.ssm_state * 1 + nh) + d_in * d
        if self.n_experts:
            per_layer += self.n_experts * 3 * d * self.moe_d_ff
            per_layer += self.n_shared_experts * 3 * d * self.moe_d_ff
            per_layer += d * self.n_experts  # router
        elif self.family != "ssm":
            n_mats = 3 if self.act == "swiglu" else 2
            per_layer += n_mats * d * self.d_ff
        total = emb + self.n_layers * per_layer
        if self.enc_layers:
            enc_per = d * self.n_heads * hd * 4 + 3 * d * self.d_ff
            total += self.enc_layers * enc_per
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        routed_all = self.n_layers * self.n_experts * 3 * d * self.moe_d_ff
        routed_act = self.n_layers * self.topk * 3 * d * self.moe_d_ff
        return self.param_count() - routed_all + routed_act
