"""qwen1.5-0.5b [hf:Qwen/Qwen1.5-0.5B]: dense 24L d=1024 16H (kv16)
d_ff=2816 vocab=151936, QKV bias, tied embeddings.

A copy of :mod:`repro.configs.qwen1_5_0_5b`: the published config and its
reduced same-family ``SMOKE`` config for CPU tests.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", family="dense", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=2816, vocab=151936, qkv_bias=True,
    tie_embeddings=True, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen1.5-0.5b-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab=512, qkv_bias=True,
    tie_embeddings=True, rope_theta=1e4,
)
