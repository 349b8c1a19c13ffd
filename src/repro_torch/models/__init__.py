"""Model zoo of the port: the decoder-only LM of the serving slice.

Mirrors :mod:`repro.models`.  ``build_model`` returns an :class:`LM` with
its parameters allocated on ``device`` (uninitialised: call ``init`` with
a generator or ``load_state_dict``).  The encoder-decoder family and the
dry-run's ``input_specs`` wait for their slices (ROADMAP §A).
"""

from __future__ import annotations

import torch

from .config import ModelConfig
from .lm import LM

__all__ = ["LM", "build_model", "ModelConfig"]


def build_model(cfg: ModelConfig, dtype=torch.float32, device="cuda") -> LM:
    if cfg.family == "encdec":
        raise NotImplementedError(
            "the encoder-decoder family (encdec.py) is not yet ported to "
            "repro_torch (ROADMAP.md §A)")
    return LM(cfg, dtype=dtype, device=device)
