"""qwen3-moe-235b-a22b: 94L d=4096 64H (GQA kv=4, head_dim=128) per-expert
ff=1536, 128 routed experts top-8, vocab=151936.  The most collective-rich
cell: experts shard 8-per-device on the 16-way model (EP) axis.

A copy of :mod:`repro.configs.qwen3_moe_235b_a22b`: the published config
and its reduced same-family ``SMOKE`` config for CPU tests.  No single
card holds it (235 B parameters): the card serves it at full width with
its depth cut, and the dry run models it whole.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe", n_layers=94, d_model=4096,
    n_heads=64, n_kv_heads=4, head_dim=128, d_ff=1536, vocab=151936,
    n_experts=128, n_shared_experts=0, topk=8, moe_d_ff=1536,
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke", family="moe", n_layers=3, d_model=64,
    n_heads=8, n_kv_heads=2, head_dim=16, d_ff=128, vocab=512,
    n_experts=16, n_shared_experts=0, topk=4, moe_d_ff=32, rope_theta=1e4,
    capacity_factor=8.0,
)
