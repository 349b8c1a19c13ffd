"""Model zoo of the port: a unified LM covering the dense, MoE, SSM,
hybrid, encoder-decoder and VLM families, and ``input_specs`` stand-ins
for a dry run.

Mirrors :mod:`repro.models`.  ``build_model`` returns an :class:`LM` (an
:class:`EncDecLM` for ``family == "encdec"``) with its parameters
allocated on ``device`` (uninitialised: call ``init`` with a generator
or ``load_state_dict``).
"""

from __future__ import annotations

from typing import Dict

import torch

from .config import SHAPES, ModelConfig, ShapeConfig
from .encdec import EncDecLM
from .lm import LM

__all__ = ["LM", "EncDecLM", "build_model", "input_specs", "ModelConfig",
           "ShapeConfig", "SHAPES"]


def build_model(cfg: ModelConfig, dtype=torch.float32, device="cuda") -> LM:
    cls = EncDecLM if cfg.family == "encdec" else LM
    return cls(cfg, dtype=dtype, device=device)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, dtype=torch.bfloat16
                ) -> Dict[str, torch.Tensor]:
    """Stand-ins (tensors on the ``meta`` device: a shape and a dtype, no
    storage) for every model input of a cell:

    * train   → {tokens, labels} (+ frames / img_embeds by family)
    * prefill → {tokens} (+ frames / img_embeds)
    * decode  → {token, pos} (the cache comes from ``model.init_cache``)
    """
    B, S = shape.global_batch, shape.seq_len

    def spec(shape_, dt):
        return torch.empty(shape_, dtype=dt, device="meta")

    i32 = torch.int32
    if shape.kind == "train":
        out = {"tokens": spec((B, S), i32), "labels": spec((B, S), i32)}
    elif shape.kind == "prefill":
        out = {"tokens": spec((B, S), i32)}
    else:  # decode: one new token against a cache of length S
        out = {"token": spec((B, 1), i32), "pos": spec((), i32)}
    if cfg.family == "encdec" and shape.kind in ("train", "prefill"):
        out["frames"] = spec((B, cfg.enc_frames, cfg.d_model), dtype)
    if cfg.family == "vlm" and shape.kind in ("train", "prefill"):
        out["img_embeds"] = spec((B, cfg.img_tokens, cfg.d_model), dtype)
    return out
