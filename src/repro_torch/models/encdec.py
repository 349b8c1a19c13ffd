"""Encoder-decoder LM (Whisper-shaped).

Mirrors :mod:`repro.models.encdec`.  The audio conv frontend is a stub, as
in the reference: the caller gives precomputed frame embeddings
``frames [B, enc_frames, d_model]`` (cast to the weights' dtype), and a
learned ``[d, d]`` projection (``frontend``) stands in for the conv
stack.  The encoder adds sinusoidal positions and runs ``enc_layers``
bidirectional attention layers (``LayerSpec(mixer="attn",
causal=False)``: no rope, the flash kernel non-causal over every frame),
then ``enc_ln``.  The decoder is the causal :class:`LM` whose layers add
cross-attention to the encoder's output (:mod:`repro_torch.models.blocks`);
prefill caches the cross K / V and :meth:`LM.decode_step`, inherited,
reads them.  ``state_dict`` keys: the :class:`LM`'s, plus ``frontend``,
``enc_ln`` and ``enc_layers.<i>.<name>``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..distributed.sharding import constrain
from .blocks import LayerSpec
from .config import ModelConfig
from .layers import ParamDef, rms_norm, softmax_xent
from .lm import LM, Block

__all__ = ["EncDecLM", "sinusoidal_positions"]


def sinusoidal_positions(S: int, d: int) -> np.ndarray:
    pos = np.arange(S)[:, None]
    dim = np.arange(d // 2)[None]
    ang = pos / (10000.0 ** (dim / (d // 2)))
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(
        np.float32)


class EncDecLM(LM):
    """``EncDecLM(cfg, dtype, device)``: the decoder's :class:`LM` and the
    encoder's parameters; every entry point takes ``frames=`` (and, as
    the reference's, ignores ``img_embeds=``)."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32, device="cuda"):
        super().__init__(cfg, dtype=dtype, device=device)
        self.enc_spec = LayerSpec(mixer="attn", causal=False)
        self.enc_layers = nn.ModuleList(
            Block(cfg, self.enc_spec, dtype, self.embed.device)
            for _ in range(cfg.enc_layers))

    def _top_defs(self) -> Dict[str, ParamDef]:
        defs = super()._top_defs()
        d = self.cfg.d_model
        defs["frontend"] = ParamDef((d, d), ("embed", "embed2"))
        defs["enc_ln"] = ParamDef((d,), ("embed",), "zeros")
        return defs

    # -- encoder --------------------------------------------------------------
    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """``frames [B, F, d_model]`` → the encoder's output [B, F, d]."""
        x = frames.to(self.frontend.dtype) @ self.frontend
        pos = torch.from_numpy(sinusoidal_positions(frames.shape[1],
                                                    self.cfg.d_model))
        x = constrain(x + pos.to(device=x.device, dtype=x.dtype)[None],
                      "act_batch", "act_seq", "act_embed")
        for blk in self.enc_layers:
            x, _ = blk(x, mode="train")
            # as the decoder's embeddings and layers: under a mesh the
            # frames' layout, and their gradient's, stays the batch's
            x = constrain(x, "act_batch", "act_seq", "act_embed")
        return rms_norm(x, self.enc_ln, self.cfg.norm_eps)

    @staticmethod
    def _need(frames: Optional[torch.Tensor]) -> torch.Tensor:
        if frames is None:
            raise ValueError("the encoder-decoder needs frames=")
        return frames

    # -- public entry points ---------------------------------------------------
    def _full_logits(self, tokens, frames):
        enc_out = self.encode(self._need(frames))
        x, prefix = self._embed_tokens(tokens)
        x, _ = self._run_blocks(x, "train", 0, enc_out=enc_out)
        return self._logits(x), prefix

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, img_embeds=None, frames=None):
        """Full-sequence logits [B, S, V] and the prefix length (0)."""
        return self._full_logits(tokens, frames)

    def loss(self, tokens: torch.Tensor, labels: torch.Tensor,
             img_embeds=None, frames=None) -> torch.Tensor:
        """Mean next-token cross-entropy, as :meth:`LM.loss`, over the
        decoder's logits given the encoder's ``frames``."""
        logits, _prefix = self._full_logits(tokens, frames)
        return softmax_xent(logits, labels, self.cfg.vocab)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache_len: int, img_embeds=None,
                frames=None):
        """Returns (cache, last-token logits [B, V], next_pos =
        ``tokens.shape[1]``); the cache holds each decoder layer's cross
        K / V over the encoder's output."""
        enc_out = self.encode(self._need(frames))
        x, _ = self._embed_tokens(tokens)
        x, cache = self._run_blocks(x, "prefill", 0, cache_len=cache_len,
                                    enc_out=enc_out)
        logits = self._logits(x[:, -1:])
        return cache, logits[:, 0], tokens.shape[1]
