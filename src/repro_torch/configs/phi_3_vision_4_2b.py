"""phi-3-vision-4.2b [hf:microsoft/Phi-3-vision-128k-instruct]: phi3-mini
backbone (32L d=3072 32H MHA d_ff=8192 vocab=32064) + CLIP frontend stub:
``input_specs`` provides precomputed patch embeddings [B, 144, 3072]
prepended to the token stream.

A copy of :mod:`repro.configs.phi_3_vision_4_2b`: the published config and its
reduced same-family ``SMOKE`` config for CPU tests.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm", n_layers=32, d_model=3072,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab=32064, img_tokens=144,
    rope_theta=1e4,
)

SMOKE = ModelConfig(
    name="phi-3-vision-smoke", family="vlm", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab=512, img_tokens=8,
    rope_theta=1e4,
)
