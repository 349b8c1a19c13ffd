"""gemma3-27b: dense 62L d=5376 32H (GQA kv=16, head_dim=128) d_ff=21504
vocab=262144, 5 local (1024-window, rope theta 1e4) : 1 global (theta 1e6)
attention pattern, 128k context; tied embeddings.

long_500k runnability: local layers keep a 1024-slot ring cache; only the
1-in-6 global layers hold the full 500k KV.

A copy of :mod:`repro.configs.gemma3_27b`: the published config and its
reduced same-family ``SMOKE`` config for CPU tests.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense", n_layers=62, d_model=5376,
    n_heads=32, n_kv_heads=16, head_dim=128, d_ff=21504, vocab=262144,
    window=1024, global_every=6, rope_theta=1e6, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma3-27b-smoke", family="dense", n_layers=7, d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=512,
    window=16, global_every=3, rope_theta=1e4, tie_embeddings=True,
)
