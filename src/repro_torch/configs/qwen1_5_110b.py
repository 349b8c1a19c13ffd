"""qwen1.5-110b [hf]: dense 80L d=8192 64H (GQA kv=8) d_ff=49152
vocab=152064, QKV bias.

A copy of :mod:`repro.configs.qwen1_5_110b`: the published config and its
reduced same-family ``SMOKE`` config for CPU tests.  No single card holds
it in bfloat16 (80 layers are 222 GB): the card serves it at full width
with its depth cut, and the dry run (:mod:`repro_torch.launch.dryrun`)
models it whole on the production mesh.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b", family="dense", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=49152, vocab=152064, qkv_bias=True,
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen1.5-110b-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=8, n_kv_heads=2, d_ff=192, vocab=512, qkv_bias=True,
    rope_theta=1e4,
)
