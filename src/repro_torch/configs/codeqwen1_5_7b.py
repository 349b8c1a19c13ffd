"""codeqwen1.5-7b [hf:Qwen/CodeQwen1.5-7B]: dense 32L d=4096 32H (kv=32 — MHA)
d_ff=13440 vocab=92416, QKV bias.

A copy of :mod:`repro.configs.codeqwen1_5_7b`: the published config and its
reduced same-family ``SMOKE`` config for CPU tests.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=32, d_ff=13440, vocab=92416, qkv_bias=True,
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="codeqwen1.5-7b-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab=512, qkv_bias=True,
    rope_theta=1e4,
)
