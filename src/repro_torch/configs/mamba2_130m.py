"""mamba2-130m [arXiv:2405.21060]: attention-free SSD, 24L d=768,
ssm_state=128, head_dim=64 (d_inner=1536 → 24 SSD heads), vocab=50280,
tied embeddings.

A copy of :mod:`repro.configs.mamba2_130m`: the published config and its
reduced same-family ``SMOKE`` config for CPU tests.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm", n_layers=24, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=0, vocab=50280, ssm_state=128,
    ssm_headdim=64, ssm_expand=2, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-130m-smoke", family="ssm", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab=512, ssm_state=16,
    ssm_headdim=16, ssm_expand=2, tie_embeddings=True,
)
