"""Instrumented, fault-tolerant training runtime.

Mirrors :mod:`repro.runtime.trainer` on one device:

* a **microbatched** train step: gradients of each microbatch are summed
  into explicit f32 buffers (``.grad`` would carry the parameter's dtype,
  so bf16 parameters would accumulate in bf16), then divided by the count;
* **checkpoint/restart**: async checkpoints every N steps; :meth:`Trainer.run`
  survives injected faults by restoring the latest committed checkpoint,
  or, with none, re-initialising from the seed's ``torch.Generator``;
* **straggler detection**: a per-step wall-time EMA; an outlier is
  recorded in the trace (``straggler_suspected``) and passed to the
  callback;
* **tracing**: ``init``, ``train``, ``data_wait``, ``train_step``,
  ``checkpoint`` and ``restore`` spans and ``fault`` /
  ``straggler_suspected`` instants, on the port's tracer.  The
  ``train_step`` span ends after ``loss.item()``, so it covers the
  device's work, as ``float(loss)`` does in the reference.

The reference jits one train step and donates its buffers; the port runs
eagerly and updates the parameters and the optimizer state in place.  As
the reference's step hands the whole batch to ``model.loss``, the port's
passes every batch key other than ``tokens`` and ``labels`` (``frames``,
``img_embeds``) to it as a keyword, split into the same microbatches.  On
the card every attention call goes through the flash kernel and its
backward kernel (:mod:`repro_torch.kernels.flash_attention`), and every
MoE router through its kernel and ``topk_gating_bwd``.  As in
the reference, ``mesh=`` and ``shardings=`` are accepted and kept, not
used; the sharded train step over a ``DeviceMesh`` is
:func:`repro_torch.launch.steps.build_cell`'s.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..core.accel import resolve_device
from ..models import build_model
from ..models.config import ModelConfig
from ..optim import adamw_init, adamw_update, cosine_schedule
from .tracer import Tracer

__all__ = ["Trainer", "TrainLoopConfig", "FaultInjector", "SimulatedFault"]


class SimulatedFault(RuntimeError):
    """Raised by FaultInjector to emulate a node loss / preemption."""


class FaultInjector:
    def __init__(self, fail_at_steps: Iterable[int] = ()):
        self.fail_at = set(fail_at_steps)
        self.fired = set()

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise SimulatedFault(f"injected fault at step {step}")


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 100
    microbatches: int = 1
    peak_lr: float = 3e-4
    warmup_steps: int = 20
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    ckpt_every: int = 0
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_keep: int = 3
    straggler_factor: float = 3.0
    log_every: int = 10
    seed: int = 0
    dtype: torch.dtype = torch.float32


class Trainer:
    """``Trainer(model_cfg, loop, device=...)`` builds the model on
    ``device`` (the card unless the caller asks for the CPU) and draws its
    parameters from ``torch.Generator(device).manual_seed(loop.seed)``.
    ``params`` are the model's parameters by ``state_dict`` name (the same
    tensors, trainable); ``opt_state`` their AdamW state."""

    def __init__(self, model_cfg: ModelConfig, loop: TrainLoopConfig,
                 tracer: Optional[Tracer] = None,
                 straggler_callback: Optional[
                     Callable[[int, float], None]] = None,
                 device="cuda", mesh=None,
                 shardings: Optional[Dict[str, Any]] = None):
        self.cfg = model_cfg
        self.loop = loop
        # kept as the reference's Trainer keeps them, and unused: the
        # sharded train step is launch.steps.build_cell's
        self.mesh = mesh
        self.shardings = shardings
        self.device = resolve_device(device)
        self.tracer = tracer or Tracer()
        self.straggler_callback = straggler_callback
        self._step_times: list = []
        self._ema: Optional[float] = None
        self.straggler_events = 0
        self.model = build_model(model_cfg, dtype=loop.dtype,
                                 device=self.device)
        self.model.requires_grad_(True)
        self.params: Dict[str, torch.Tensor] = dict(
            self.model.named_parameters())
        with self.tracer.span("init"):
            self._init_state()
        self.step = 0
        self.ckpt = CheckpointManager(loop.ckpt_dir, keep=loop.ckpt_keep) \
            if loop.ckpt_every else None

    def _init_state(self) -> None:
        gen = torch.Generator(device=self.device).manual_seed(self.loop.seed)
        self.model.init(gen)
        self.opt_state = adamw_init(self.params)

    # ------------------------------------------------------------------
    def _grads(self, tokens: torch.Tensor, labels: torch.Tensor,
               **extras: torch.Tensor):
        """(loss, f32 gradients by name) of one batch, over
        ``loop.microbatches`` microbatches summed in f32.  ``extras`` (the
        batch's other keys: ``frames``, ``img_embeds``) go to
        ``model.loss`` as keywords, each split into the same microbatches
        as the tokens.  A parameter the loss does not read (whisper's
        cross-attention ``x_bk`` / ``x_bv``) gets a zero gradient, as under
        ``jax.value_and_grad``."""
        M = self.loop.microbatches
        names = list(self.params)
        leaves = [self.params[k] for k in names]

        def grads(loss):
            return torch.autograd.grad(loss, leaves, allow_unused=True,
                                       materialize_grads=True)

        if M == 1:
            loss = self.model.loss(tokens, labels, **extras)
            gs = list(grads(loss))
            out = {}
            for i, k in enumerate(names):   # each cast frees its bf16 input
                out[k], gs[i] = gs[i].float(), None
            return loss.detach(), out
        if tokens.shape[0] % M:
            raise ValueError(f"batch {tokens.shape[0]} does not split into "
                             f"{M} microbatches")
        acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in self.params.items()}
        losses = []
        chunks = {k: v.chunk(M) for k, v in extras.items()}
        for m, (tok, lab) in enumerate(zip(tokens.chunk(M),
                                           labels.chunk(M))):
            loss = self.model.loss(tok, lab, **{k: c[m]
                                                for k, c in chunks.items()})
            for k, g in zip(names, grads(loss)):
                acc[k].add_(g.float())
            losses.append(loss.detach())
        return torch.stack(losses).mean(), {k: a / M for k, a in acc.items()}

    def _train_step(self, batch: Dict[str, Any]) -> torch.Tensor:
        """One step on ``batch``: ``tokens`` and ``labels``, and every other
        key passed to ``model.loss`` as a keyword, as the reference's
        ``model.loss(params, batch)`` reads the whole batch; each entry (a
        NumPy array or a tensor) moved to the trainer's device."""
        loop = self.loop

        def to_device(v):
            t = v if isinstance(v, torch.Tensor) else \
                torch.from_numpy(np.asarray(v))
            return t.to(self.device)

        tokens = to_device(batch["tokens"]).long()
        labels = to_device(batch["labels"]).long()
        extras = {k: to_device(v) for k, v in batch.items()
                  if k not in ("tokens", "labels")}
        loss, grads = self._grads(tokens, labels, **extras)
        lr = cosine_schedule(self.opt_state.step, loop.peak_lr,
                             loop.warmup_steps, loop.steps)
        adamw_update(self.params, grads, self.opt_state, lr,
                     weight_decay=loop.weight_decay,
                     clip_norm=loop.clip_norm)
        return loss

    # ------------------------------------------------------------------
    def train_one(self, batch: Dict[str, np.ndarray], step: int,
                  fault: Optional[FaultInjector] = None) -> float:
        t0 = time.perf_counter()
        with self.tracer.span("train_step"):
            loss = self._train_step(batch).item()
        if fault is not None:
            fault.maybe_fail(step)
        dt = time.perf_counter() - t0
        self._observe_step_time(step, dt)
        return loss

    def _observe_step_time(self, step: int, dt: float) -> None:
        if self._ema is None:
            self._ema = dt
        if dt > self.loop.straggler_factor * self._ema and step > 2:
            self.straggler_events += 1
            self.tracer.instant("straggler_suspected")
            if self.straggler_callback:
                self.straggler_callback(step, dt / self._ema)
        self._ema = 0.9 * self._ema + 0.1 * dt
        self._step_times.append(dt)

    # ------------------------------------------------------------------
    def state_tree(self) -> Dict[str, Any]:
        """The checkpointed state: ``params/<name>``, ``opt/m/<name>``,
        ``opt/v/<name>`` and ``opt/step`` (int32, as the reference's)."""
        return {"params": {k: p.detach() for k, p in self.params.items()},
                "opt": {"m": self.opt_state.m, "v": self.opt_state.v,
                        "step": torch.tensor(self.opt_state.step,
                                             dtype=torch.int32)}}

    def save_ckpt(self) -> None:
        if self.ckpt is None:
            return
        with self.tracer.span("checkpoint"):
            self.ckpt.save(self.step, self.state_tree(),
                           extra={"model": self.cfg.name})

    @torch.no_grad()
    def restore_latest(self) -> bool:
        if self.ckpt is None:
            return False
        self.ckpt.wait()   # an in-flight async write may hold the newest step
        step = self.ckpt.latest_step()
        if step is None:
            return False
        with self.tracer.span("restore"):
            state = self.ckpt.restore(step, self.state_tree())
            for k, p in self.params.items():
                p.copy_(state["params"][k])
            for mine, got in ((self.opt_state.m, state["opt"]["m"]),
                              (self.opt_state.v, state["opt"]["v"])):
                for k, t in mine.items():
                    t.copy_(got[k])
            self.opt_state.step = int(state["opt"]["step"])
            self.step = step
        return True

    # ------------------------------------------------------------------
    def run(self, stream, fault: Optional[FaultInjector] = None,
            max_restarts: int = 3) -> Dict[str, Any]:
        """Train loop with restart-on-fault.  Returns summary stats."""
        losses = []
        restarts = 0
        loop = self.loop
        with self.tracer.span("train"):
            while self.step < loop.steps:
                try:
                    with self.tracer.span("data_wait"):
                        batch = stream.batch_at(self.step)
                    loss = self.train_one(batch, self.step, fault)
                    losses.append(loss)
                    self.step += 1
                    if loop.ckpt_every and self.step % loop.ckpt_every == 0:
                        self.save_ckpt()
                except SimulatedFault:
                    restarts += 1
                    self.tracer.instant("fault")
                    if restarts > max_restarts:
                        raise
                    if not self.restore_latest():
                        self.step = 0  # cold restart
                        self._init_state()
        if self.ckpt is not None:
            self.ckpt.wait()
        return {"losses": losses, "restarts": restarts,
                "straggler_events": self.straggler_events,
                "steps": self.step,
                "mean_step_time": float(np.mean(self._step_times[1:]))
                if len(self._step_times) > 1 else None}
