"""hymba-1.5b [arXiv:2411.13676]: hybrid 32L d=1600, 25 attn heads (GQA kv=5,
head_dim=64) in parallel with Mamba heads (ssm_state=16), d_ff=5504,
vocab=32001, 128 meta tokens (always-attendable prefix), 1024 sliding window.

Deviation noted in DESIGN.md: the paper keeps 3 full-attention layers; we use
SWA+meta everywhere (bounded cache on all layers for long_500k).
25 heads do not divide the 16-way TP axis → attention heads stay replicated;
SSM d_inner and MLP shard TP.

A copy of :mod:`repro.configs.hymba_1_5b`: the published config and its
reduced same-family ``SMOKE`` config for CPU tests.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid", n_layers=32, d_model=1600,
    n_heads=25, n_kv_heads=5, head_dim=64, d_ff=5504, vocab=32001,
    ssm_state=16, ssm_headdim=64, ssm_expand=2, window=1024,
    meta_tokens=128, rope_theta=1e4,
)

SMOKE = ModelConfig(
    name="hymba-1.5b-smoke", family="hybrid", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=512,
    ssm_state=8, ssm_headdim=16, ssm_expand=2, window=16, meta_tokens=8,
    rope_theta=1e4,
)
