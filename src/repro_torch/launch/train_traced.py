"""End-to-end run: train the paper-native ~100M LM while the port's
tracer records the run, then analyse the training trace with the port's
own Pipit on the same device — the paper's loop closed on the port.

Mirrors ``examples/train_traced.py``, on the card unless ``--device cpu``::

    PYTHONPATH=src python -m repro_torch.launch.train_traced --steps 200
    PYTHONPATH=src python -m repro_torch.launch.train_traced --smoke \\
        --steps 20 --inject-fault --device cpu

:func:`train_traced` is the body: it trains (checkpoints every
``ckpt_every`` steps, a fault injected at ``fault_at``), then turns the
tracer's buffer into a :class:`~repro_torch.Trace` on ``device`` and runs
``flat_profile()`` (the ``seg_sum`` kernel on the card) and
``time_profile(num_bins=8)`` (``time_bin``).  It returns the trainer's
summary, the trace and both profiles.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..data import SyntheticLMStream
from ..runtime import FaultInjector, Tracer, Trainer, TrainLoopConfig

__all__ = ["TracedRun", "train_traced", "main"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class TracedRun:
    summary: Dict[str, Any]
    trainer: Trainer
    trace: Any
    flat_profile: Any
    time_profile: Any


def train_traced(steps: int = 200, batch: int = 8, seq: int = 128,
                 smoke: bool = False, fault_at: Optional[int] = None,
                 ckpt_every: Optional[int] = None,
                 ckpt_dir: Optional[str] = None, dtype: str = "float32",
                 device="cuda") -> TracedRun:
    """The example's run: ``pipit-lm-100m`` (or its smoke config) trained
    for ``steps`` steps on ``SyntheticLMStream(vocab, batch, seq,
    seed=1)`` at a peak learning rate of 3e-3, warm-up ``steps // 10``, a
    checkpoint every ``ckpt_every`` steps (default ``steps // 4``), then
    the trace's two profiles."""
    cfg = get_smoke_config("pipit-lm-100m") if smoke \
        else get_config("pipit-lm-100m")
    tracer = Tracer()
    loop = TrainLoopConfig(
        steps=steps, peak_lr=3e-3, warmup_steps=max(steps // 10, 1),
        ckpt_every=ckpt_every or max(steps // 4, 1),
        ckpt_dir=ckpt_dir or os.path.join(tempfile.gettempdir(),
                                          "repro_torch_e2e_ckpt"),
        dtype=DTYPES[dtype])
    trainer = Trainer(cfg, loop, tracer=tracer, device=device)
    stream = SyntheticLMStream(cfg.vocab, batch, seq, seed=1)
    fault = FaultInjector([fault_at]) if fault_at is not None else None
    try:
        out = trainer.run(stream, fault=fault)
    finally:
        stream.close()
    trace = tracer.to_trace("train_run", device=device)
    return TracedRun(out, trainer, trace, trace.flat_profile(),
                     trace.time_profile(num_bins=8))


def main(argv=None) -> TracedRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--inject-fault", action="store_true",
                    help="fail once at step steps // 2")
    ap.add_argument("--ckpt-every", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    cfg = get_smoke_config("pipit-lm-100m") if args.smoke \
        else get_config("pipit-lm-100m")
    print(f"training {cfg.name}: ~{cfg.param_count() / 1e6:.0f}M params, "
          f"{args.steps} steps, batch {args.batch}×{args.seq}")
    run = train_traced(args.steps, args.batch, args.seq, smoke=args.smoke,
                       fault_at=args.steps // 2 if args.inject_fault
                       else None, ckpt_every=args.ckpt_every,
                       ckpt_dir=args.ckpt_dir, dtype=args.dtype,
                       device=args.device)
    out, losses = run.summary, run.summary["losses"]
    print(f"\nloss: {np.mean(losses[:5]):.4f} → {np.mean(losses[-5:]):.4f} "
          f"({out['steps']} steps, {out['restarts']} restarts, "
          f"{out['mean_step_time']:.3f}s/step)")
    print("\nPipit flat profile of the training run:")
    print(run.flat_profile.head(8))
    print("\nPipit time profile (8 bins):")
    print(run.time_profile.head(8))
    return run


if __name__ == "__main__":
    main()
