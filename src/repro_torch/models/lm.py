"""Decoder-only LM as an ``nn.Module``.

Mirrors :class:`repro.models.lm.LM` for the dense, MoE, SSM, hybrid and
VLM families: attention layers (full, or gemma3's 5 local : 1 global
interleave), Mamba-2 layers, Hymba's parallel attention + SSM layers
and its learnable meta-token prefix, and phi-3-vision's image
embeddings (``img_embeds`` ``[B, img_tokens, d_model]``, prepended
before any meta tokens: the positions count them, and the loss drops
them; the attention stays causal over them, as the reference's, whose
``prefix_len`` is the meta tokens' alone).  The encoder-decoder builds
on it (:class:`repro_torch.models.encdec.EncDecLM`).  Where the
reference stacks the layers' parameters in periods and scans them
(``lax.scan``), the port keeps one :class:`Block` per layer in a
``ModuleList`` and loops (:func:`plan_layers` flattens the period and
the tail to one spec a layer); the cache is a list with one dict per layer, whose entries and
shapes follow the layer (a ring or a full KV cache, meta K/V, an SSM
state).  Parameters keep the reference's names and ``[in, out]`` layout
(``state_dict`` keys ``embed``, ``final_ln``, ``unembed``, ``meta`` and
``layers.<i>.<name>``), so :func:`repro_torch.convert.params_from_jax`
only unstacks.  They are
made without ``requires_grad``; the trainer turns it on
(``model.requires_grad_(True)``) and calls :meth:`LM.loss`, the one entry
point that runs with grad on.  Serving's :meth:`LM.forward`,
:meth:`LM.prefill` and :meth:`LM.decode_step` stay under
``torch.no_grad()``.  The reference's three activation constraints
(the embeddings, each layer's output, the logits) stand at the same
points; outside :func:`repro_torch.distributed.sharding.
activation_sharding` they do nothing.  :meth:`LM.param_defs` gives the
sharding rules each parameter's logical axes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..core.accel import resolve_device
from ..distributed.sharding import constrain
from .blocks import LayerSpec, cache_defs, layer_apply, layer_defs
from .config import ModelConfig
from .layers import (ParamDef, abstract_tree, init_param, rms_norm,
                     softmax_xent)

__all__ = ["LM", "Block", "plan_layers"]


def plan_layers(cfg: ModelConfig) -> Tuple[LayerSpec, ...]:
    """One spec per layer: the reference's (pattern within a period,
    n_periods, tail) flattened, layer ``n * period + i`` taking the
    pattern's ``i``-th spec and the tail the last layers.  gemma3-style
    configs (``global_every``) interleave ``global_every - 1`` local
    window layers (rope theta 1e4) with one global layer; the
    encoder-decoder's decoder layers add cross-attention (its encoder's
    layers are :class:`repro_torch.models.encdec.EncDecLM`'s)."""
    if cfg.family == "encdec":
        return (LayerSpec(mixer="attn", cross=True),) * cfg.n_layers
    if cfg.family == "ssm":
        base = LayerSpec(mixer="ssm")
    elif cfg.family == "hybrid":
        base = LayerSpec(mixer="hybrid", window=cfg.window, moe=False)
    elif cfg.family == "moe":
        base = LayerSpec(mixer="attn", moe=True)
    else:                      # dense | vlm
        base = LayerSpec(mixer="attn", window=cfg.window)
    if cfg.global_every:       # gemma3-style local:global interleave
        local = LayerSpec(mixer="attn", window=cfg.window, rope_theta=1e4)
        glob = LayerSpec(mixer="attn", window=None,
                         rope_theta=cfg.rope_theta)
        pattern = (local,) * (cfg.global_every - 1) + (glob,)
        n_periods = cfg.n_layers // len(pattern)
        tail = (local,) * (cfg.n_layers - n_periods * len(pattern))
        return pattern * n_periods + tail
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
                cache: Optional[dict] = None, enc_out=None,
                cache_len: int = 0):
        return layer_apply(self._parameters, x, self.cfg, self.spec,
                           mode=mode, pos=pos, cache=cache, enc_out=enc_out,
                           cache_len=cache_len)


class LM(nn.Module):
    """``LM(cfg, dtype, device)`` allocates the parameters uninitialised
    on ``device`` (the card unless the caller asks for the CPU; raises
    without one); :meth:`init` draws them from a generator, or
    ``load_state_dict`` fills them."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
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
        if cfg.meta_tokens:
            defs["meta"] = ParamDef((cfg.meta_tokens, d), (None, "embed"),
                                    scale=float(d ** 0.5))
        return defs

    # -- parameters ---------------------------------------------------------
    def param_defs(self) -> Dict[str, ParamDef]:
        """{``state_dict`` name: ParamDef} of every parameter: the
        reference's tree without its stacked ``layers`` axis."""
        defs = dict(self.top_defs)
        for name, mod in self.named_modules():
            if isinstance(mod, Block):
                defs.update({f"{name}.{k}": d for k, d in mod.defs.items()})
        return defs

    def abstract_params(self, dtype=torch.bfloat16
                        ) -> Dict[str, torch.Tensor]:
        """{``state_dict`` name: meta-device stand-in} of every parameter
        in ``dtype``: shapes without storage."""
        return abstract_tree(self.param_defs(), dtype)

    def cache_defs(self, batch: int, cache_len: int
                   ) -> List[Dict[str, ParamDef]]:
        """The serve cache's ParamDefs, one dict per layer, as
        :meth:`init_cache` lays it out."""
        return [cache_defs(self.cfg, s, batch, cache_len)
                for s in self.specs]

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "LM":
        """Draw every parameter from ``generator`` at its ParamDef's rule,
        in declaration order (top-level, then layer by layer).  A DTensor
        parameter (placed on a mesh) draws the whole tensor, as every rank
        does alike, and keeps its own shard."""
        from torch.distributed.tensor import DTensor, distribute_tensor
        owners = [(self, self.top_defs)] + [
            (b, b.defs) for b in self.modules() if isinstance(b, Block)]
        for mod, defs in owners:
            for name, d in defs.items():
                p = mod._parameters[name].data
                if not isinstance(p, DTensor):
                    init_param(d, generator, p)
                    continue
                local = p.to_local()
                full = init_param(d, generator, torch.empty(
                    d.shape, dtype=p.dtype, device=local.device))
                local.copy_(distribute_tensor(
                    full, p.device_mesh, p.placements,
                    src_data_rank=None).to_local())
        return self

    # -- cache --------------------------------------------------------------
    def init_cache(self, batch: int, cache_len: int, dtype=torch.float32,
                   abstract: bool = False) -> List[Dict[str, torch.Tensor]]:
        """A zeroed serve cache, one dict per layer, or with ``abstract``
        its stand-ins on the ``meta`` device.  SSD states are f32 (they
        accumulate); KV and conv caches take ``dtype``."""
        dev = torch.device("meta") if abstract else self.embed.device
        return [{k: torch.zeros(d.shape, device=dev,
                                dtype=torch.float32 if k == "ssm_h"
                                else dtype)
                 for k, d in cache_defs(self.cfg, s, batch, cache_len).items()}
                for s in self.specs]

    # -- forward ------------------------------------------------------------
    def _run_blocks(self, x, mode: str, pos: int, cache=None,
                    cache_len: int = 0, enc_out=None):
        new_cache = []
        for i, blk in enumerate(self.layers):
            x, nc = blk(x, mode=mode, pos=pos,
                        cache=cache[i] if cache is not None else None,
                        enc_out=enc_out, cache_len=cache_len)
            x = constrain(x, "act_batch", "act_seq", "act_embed")
            new_cache.append(nc)
        return x, (new_cache if mode in ("prefill", "decode") else None)

    def _logits(self, x):
        x = rms_norm(x, self.final_ln, self.cfg.norm_eps)
        w = self.embed.T if self.cfg.tie_embeddings else self.unembed
        return constrain(x @ w, "act_batch", "act_seq", "act_vocab")

    def _embed_tokens(self, tokens: torch.Tensor,
                      img_embeds: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, int]:
        """Token embeddings behind the image embeddings (phi-3-vision, cast
        to the embeddings' dtype) and the meta-token prefix (Hymba), in
        that order, and the length of both prefixes."""
        x = self.embed[tokens]
        pre = []
        if img_embeds is not None:
            pre.append(img_embeds.to(x.dtype))
        if self.cfg.meta_tokens:
            pre.append(self.meta[None].expand((tokens.shape[0],)
                                              + self.meta.shape))
        if pre:
            x = torch.cat(pre + [x], dim=1)
        return (constrain(x, "act_batch", "act_seq", "act_embed"),
                sum(t.shape[1] for t in pre))

    def _full_logits(self, tokens: torch.Tensor, img_embeds=None
                     ) -> Tuple[torch.Tensor, int]:
        x, prefix = self._embed_tokens(tokens, img_embeds)
        x, _ = self._run_blocks(x, "train", 0)
        return self._logits(x), prefix

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, img_embeds=None):
        """Full-sequence logits [B, prefix + S, V] and the prefix length
        (the image embeddings' and the meta tokens'): the greedy oracle of
        the tests."""
        return self._full_logits(tokens, img_embeds)

    def loss(self, tokens: torch.Tensor, labels: torch.Tensor,
             img_embeds=None) -> torch.Tensor:
        """Mean next-token cross-entropy of ``tokens`` [B, S] against
        ``labels`` [B, S] (:meth:`repro.models.lm.LM.loss`; the prefix
        positions dropped), with grad on wherever the caller's grad mode
        has it: the training entry point."""
        logits, prefix = self._full_logits(tokens, img_embeds)
        return softmax_xent(logits[:, prefix:], labels, self.cfg.vocab)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache_len: int, img_embeds=None):
        """Returns (cache, last-token logits [B, V], next_pos); next_pos
        counts the image and meta prefixes."""
        x, _prefix = self._embed_tokens(tokens, img_embeds)
        S_total = x.shape[1]
        x, cache = self._run_blocks(x, "prefill", 0, cache_len=cache_len)
        logits = self._logits(x[:, -1:])
        return cache, logits[:, 0], S_total

    @torch.no_grad()
    def decode_step(self, cache, token: torch.Tensor, pos: int,
                    cache_len: int):
        """token [B, 1] int; pos: tokens so far, the prefix included.
        Returns (logits [B, V], new_cache) — KV caches are updated in
        place, SSM states replaced."""
        x = self.embed[token]
        x, new_cache = self._run_blocks(x, "decode", pos, cache=cache,
                                        cache_len=cache_len)
        return self._logits(x)[:, 0], new_cache
