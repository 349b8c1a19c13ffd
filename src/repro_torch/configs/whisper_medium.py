"""whisper-medium [arXiv:2212.04356]: enc-dec audio transformer.

24 encoder + 24 decoder layers, d_model=1024, 16 heads (kv=16), d_ff=4096,
vocab=51865.  Conv audio frontend is a stub: ``input_specs`` supplies
precomputed frame embeddings [B, 1500, 1024] (a learned linear projection
stands in for the conv stack).  GELU MLPs, QKV bias, tied embeddings.

A copy of :mod:`repro.configs.whisper_medium`: the published config and its
reduced same-family ``SMOKE`` config for CPU tests.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=4096, vocab=51865, enc_layers=24,
    enc_frames=1500, act="gelu", qkv_bias=True, tie_embeddings=True,
    rope_theta=1e4,
)

SMOKE = ModelConfig(
    name="whisper-medium-smoke", family="encdec", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab=512, enc_layers=2,
    enc_frames=24, act="gelu", qkv_bias=True, tie_embeddings=True,
    rope_theta=1e4,
)
