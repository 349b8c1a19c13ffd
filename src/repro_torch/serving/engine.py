"""Batched serving engine: prefill + decode over waves of requests.

Mirrors :mod:`repro.serving.engine`.  ``ServeEngine`` keeps B decode
slots.  Each admission wave is left-padded with token 0 to one prompt
length — the pad tokens are attended to, unmasked, as in the reference —
prefilled in one call, then decoded together.  The model keeps one cache
dict a layer, of whatever shape the layer needs (a ring of ``window``
slots or a full KV cache, meta K/V, an SSM state), and the decode
position counts the model's meta-token prefix, as the reference's
``S_total`` does.  ``generate`` and ``serve_queue`` take the model's
extra inputs as keywords (``frames=`` for the encoder-decoder,
``img_embeds=`` for the VLM) and hand them to every wave's prefill, as
the reference does: one tensor for all waves, so its batch is the
wave's.  Greedy sampling by default
(the first maximum, as ``jnp.argmax``); with a temperature, categorical
sampling from an explicit ``torch.Generator``, whose draws differ from
``jax.random``'s.  Every phase emits Pipit events (``init``, ``wave``,
``prefill``, ``decode``, ``decode_step``), the reference's spans; on the
card ``prefill`` and ``decode_step`` end only when the device is done, so
their times are the device's, not the launch queue's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from ..core.accel import resolve_device
from ..models import build_model
from ..models.config import ModelConfig
from ..runtime.tracer import Tracer

__all__ = ["Request", "ServeEngine"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # [S] int32
    max_new_tokens: int = 16
    out_tokens: Optional[List[int]] = None


class ServeEngine:
    """``params``: a state dict for the model (e.g. from
    :func:`repro_torch.convert.params_from_jax`), or None to draw the
    weights from ``torch.Generator(device).manual_seed(seed)``.
    ``logits_hook(phase, logits)``, when set, sees every prefill and
    decode step's logits (``phase`` is ``"prefill"`` or ``"decode"``).
    ``model``: a built model to serve instead of a new one, its weights
    kept unless ``params`` is given."""

    def __init__(self, cfg: ModelConfig, batch: int, cache_len: int,
                 params=None, tracer: Optional[Tracer] = None,
                 dtype=torch.float32, temperature: float = 0.0,
                 seed: int = 0, device="cuda", model=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = (model if model is not None else
                      build_model(cfg, dtype=dtype, device=self.device))
        self.batch = batch
        self.cache_len = cache_len
        self.tracer = tracer or Tracer()
        self.temperature = temperature
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.logits_hook: Optional[Callable[[str, torch.Tensor], None]] = None
        if params is not None:
            self.model.load_state_dict(params)
        elif model is None:
            with self.tracer.span("init"):
                self.model.init(torch.Generator(
                    device=self.device).manual_seed(seed))
                self._sync()

    # ------------------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _prefill(self, tokens: torch.Tensor, **extras):
        with self.tracer.span("prefill"):
            out = self.model.prefill(tokens, self.cache_len, **extras)
            self._sync()
        return out

    def _decode(self, cache, token: torch.Tensor, pos: int):
        with self.tracer.span("decode_step"):
            out = self.model.decode_step(cache, token, pos, self.cache_len)
            self._sync()
        return out

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        logits = logits[..., :self.cfg.vocab]
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).cpu().numpy()
        probs = torch.softmax(logits.float() / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator
                                 )[:, 0].cpu().numpy()

    def _hook(self, phase: str, logits: torch.Tensor) -> None:
        if self.logits_hook is not None:
            self.logits_hook(phase, logits)

    def generate(self, requests: List[Request], **extras) -> List[Request]:
        """Serve a wave of ≤batch requests (left-padded to one prompt
        length); ``extras`` go to the model's prefill."""
        if len(requests) > self.batch:
            raise ValueError(f"a wave holds at most {self.batch} requests, "
                             f"got {len(requests)}")
        reqs = list(requests)
        B = len(reqs)
        S = max(len(r.prompt) for r in reqs)
        prompts = np.zeros((B, S), np.int64)
        for i, r in enumerate(reqs):
            prompts[i, S - len(r.prompt):] = r.prompt  # left-pad
        cache, logits, pos = self._prefill(
            torch.from_numpy(prompts).to(self.device), **extras)
        self._hook("prefill", logits)
        tok = self._sample(logits)
        for r, t in zip(reqs, tok):
            r.out_tokens = [int(t)]
        steps = max(r.max_new_tokens for r in reqs) - 1
        with self.tracer.span("decode"):
            cur = torch.from_numpy(tok[:, None].astype(np.int64)).to(
                self.device)
            p = pos
            for _ in range(steps):
                logits, cache = self._decode(cache, cur, p)
                self._hook("decode", logits)
                tok = self._sample(logits)
                for r, t in zip(reqs, tok):
                    if len(r.out_tokens) < r.max_new_tokens:
                        r.out_tokens.append(int(t))
                cur = torch.from_numpy(tok[:, None].astype(np.int64)).to(
                    self.device)
                p = p + 1
        return reqs

    def serve_queue(self, queue: List[Request], **extras) -> List[Request]:
        """Slot-based batching: admit up to `batch` requests per wave;
        ``extras`` go to every wave's prefill."""
        done: List[Request] = []
        i = 0
        while i < len(queue):
            wave = queue[i:i + self.batch]
            with self.tracer.span("wave"):
                done.extend(self.generate(wave, **extras))
            i += self.batch
        return done
