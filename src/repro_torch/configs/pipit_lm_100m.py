"""pipit-lm-100m: the paper-native end-to-end config — a ~100M dense LM
the trainer runs while the Pipit tracer records the execution
(:mod:`repro_torch.launch.train_traced`).

A copy of :mod:`repro.configs.pipit_lm_100m`: the published config and its
reduced same-family ``SMOKE`` config for CPU tests.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="pipit-lm-100m", family="dense", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=3072, vocab=32000, tie_embeddings=True,
    rope_theta=1e4,
)

SMOKE = ModelConfig(
    name="pipit-lm-100m-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab=512, tie_embeddings=True,
    rope_theta=1e4,
)
