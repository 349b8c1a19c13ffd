"""Decoder-only LM as an ``nn.Module``.

Mirrors :class:`repro.models.lm.LM` for the families of the serving slice
(dense and MoE attention layers).  Where the reference stacks the layers'
parameters and scans them (``lax.scan``), the port keeps one
:class:`Block` per layer in a ``ModuleList`` and loops; the cache is a
list with one ``{"k_cache", "v_cache"}`` dict per layer.  Parameters keep
the reference's names and ``[in, out]`` layout (``state_dict`` keys
``embed``, ``final_ln``, ``unembed`` and ``layers.<i>.<name>``), so
:func:`repro_torch.convert.params_from_jax` only unstacks.  They carry no
gradient: training is a later slice.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..core.accel import resolve_device
from .blocks import LayerSpec, cache_defs, layer_apply, layer_defs
from .config import ModelConfig
from .layers import ParamDef, init_param, rms_norm

__all__ = ["LM", "Block", "plan_layers"]


def plan_layers(cfg: ModelConfig) -> Tuple[LayerSpec, ...]:
    """One spec per layer.  The gemma3-style local/global interleave and
    the SSM / hybrid families raise until their slice is ported."""
    if cfg.family in ("ssm", "hybrid", "encdec") or cfg.global_every:
        raise NotImplementedError(
            f"family {cfg.family!r} (global_every={cfg.global_every}) not "
            f"yet ported to repro_torch (ROADMAP.md §A: local / window "
            f"attention, ssm.py, encdec.py)")
    if cfg.family == "moe":
        base = LayerSpec(mixer="attn", moe=True)
    else:                      # dense | vlm
        base = LayerSpec(mixer="attn", window=cfg.window)
    return (base,) * cfg.n_layers


def _empty(defs: Dict[str, ParamDef], dtype, device) -> Dict[str, nn.Parameter]:
    return {k: nn.Parameter(torch.empty(d.shape, dtype=dtype, device=device),
                            requires_grad=False) for k, d in defs.items()}


class Block(nn.Module):
    """One layer's parameters (named as in the reference) and its apply."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, dtype, device):
        super().__init__()
        self.cfg, self.spec = cfg, spec
        self.defs = layer_defs(cfg, spec)
        for name, prm in _empty(self.defs, dtype, device).items():
            self.register_parameter(name, prm)

    def forward(self, x, mode: str = "train", pos: int = 0,
                cache: Optional[dict] = None, cache_len: int = 0):
        return layer_apply(self._parameters, x, self.cfg, self.spec,
                           mode=mode, pos=pos, cache=cache,
                           cache_len=cache_len)


class LM(nn.Module):
    """``LM(cfg, dtype, device)`` allocates the parameters uninitialised
    on ``device`` (the card unless the caller asks for the CPU; raises
    without one); :meth:`init` draws them from a generator, or
    ``load_state_dict`` fills them."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        if cfg.meta_tokens or cfg.img_tokens:
            raise NotImplementedError(
                "meta tokens and image embeddings not yet ported to "
                "repro_torch (ROADMAP.md §A)")
        self.cfg = cfg
        self.specs = plan_layers(cfg)
        self.top_defs = self._top_defs()
        for name, prm in _empty(self.top_defs, dtype, device).items():
            self.register_parameter(name, prm)
        self.layers = nn.ModuleList(Block(cfg, s, dtype, device)
                                    for s in self.specs)

    def _top_defs(self) -> Dict[str, ParamDef]:
        cfg = self.cfg
        d, V = cfg.d_model, cfg.padded_vocab
        defs = {"embed": ParamDef((V, d), ("vocab", "embed"),
                                  scale=float((V / d) ** 0.5)),
                "final_ln": ParamDef((d,), ("embed",), "zeros")}
        if not cfg.tie_embeddings:
            defs["unembed"] = ParamDef((d, V), ("embed", "vocab"))
        return defs

    # -- parameters ---------------------------------------------------------
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "LM":
        """Draw every parameter from ``generator`` at its ParamDef's rule,
        in declaration order (top-level, then layer by layer)."""
        owners = [(self, self.top_defs)] + [(b, b.defs) for b in self.layers]
        for mod, defs in owners:
            for name, d in defs.items():
                prm = mod._parameters[name]
                prm.copy_(init_param(d, generator, dtype=prm.dtype,
                                     device=prm.device))
        return self

    # -- cache --------------------------------------------------------------
    def init_cache(self, batch: int, cache_len: int,
                   dtype=torch.float32) -> List[Dict[str, torch.Tensor]]:
        """A zeroed KV cache, one dict per layer."""
        dev = self.embed.device
        return [{k: torch.zeros(d.shape, dtype=dtype, device=dev)
                 for k, d in cache_defs(self.cfg, s, batch, cache_len).items()}
                for s in self.specs]

    # -- forward ------------------------------------------------------------
    def _run_blocks(self, x, mode: str, pos: int, cache=None,
                    cache_len: int = 0):
        new_cache = []
        for i, blk in enumerate(self.layers):
            x, nc = blk(x, mode=mode, pos=pos,
                        cache=cache[i] if cache is not None else None,
                        cache_len=cache_len)
            new_cache.append(nc)
        return x, (new_cache if mode in ("prefill", "decode") else None)

    def _logits(self, x):
        x = rms_norm(x, self.final_ln, self.cfg.norm_eps)
        w = self.embed.T if self.cfg.tie_embeddings else self.unembed
        return x @ w

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor):
        """Full-sequence logits [B, S, V] and the prefix length (0 here):
        the greedy oracle of the tests."""
        x = self.embed[tokens]
        x, _ = self._run_blocks(x, "train", 0)
        return self._logits(x), 0

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache_len: int):
        """Returns (cache, last-token logits [B, V], next_pos)."""
        x = self.embed[tokens]
        S_total = x.shape[1]
        x, cache = self._run_blocks(x, "prefill", 0, cache_len=cache_len)
        logits = self._logits(x[:, -1:])
        return cache, logits[:, 0], S_total

    @torch.no_grad()
    def decode_step(self, cache, token: torch.Tensor, pos: int,
                    cache_len: int):
        """token [B, 1] int; pos: tokens so far.  Returns (logits [B, V],
        new_cache) — the cache is updated in place."""
        x = self.embed[token]
        x, new_cache = self._run_blocks(x, "decode", pos, cache=cache,
                                        cache_len=cache_len)
        return self._logits(x)[:, 0], new_cache
