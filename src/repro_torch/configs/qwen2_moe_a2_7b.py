"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B]: 24L d=2048 16H(kv16)
per-expert ff=1408, 60 routed experts top-4 + 4 shared experts, QKV bias.

A copy of :mod:`repro.configs.qwen2_moe_a2_7b`: the published config and
its reduced same-family ``SMOKE`` config for CPU tests.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=5632, vocab=151936, qkv_bias=True,
    n_experts=60, n_shared_experts=4, topk=4, moe_d_ff=1408,
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen2-moe-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=256, vocab=512, qkv_bias=True,
    n_experts=8, n_shared_experts=2, topk=2, moe_d_ff=32, rope_theta=1e4,
    capacity_factor=8.0,
)
