"""Training launcher.

Mirrors :mod:`repro.launch.train`, on the card unless ``--device cpu``::

    PYTHONPATH=src python -m repro_torch.launch.train --arch pipit-lm-100m \\
        --steps 200 --batch 16 --seq 256 [--smoke] [--trace out.jsonl]

It runs the :class:`~repro_torch.runtime.Trainer` on one device (bf16
parameters unless ``--f32``; weights drawn from seed 0) over the synthetic
stream, prints the reference's JSON summary and can write the run's Pipit
trace.  The reference's production mesh is not ported (ROADMAP §A).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from ..configs import get_config, get_smoke_config
from ..data import SyntheticLMStream
from ..runtime import Tracer, Trainer, TrainLoopConfig

__all__ = ["main"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="pipit-lm-100m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--trace", default=None,
                    help="write the run's Pipit trace (jsonl) here")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    loop = TrainLoopConfig(
        steps=args.steps, microbatches=args.microbatches, peak_lr=args.lr,
        warmup_steps=max(args.steps // 10, 1), ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir,
        dtype=torch.float32 if args.f32 else torch.bfloat16)
    tracer = Tracer()
    trainer = Trainer(cfg, loop, tracer=tracer, device=args.device)
    stream = SyntheticLMStream(cfg.vocab, args.batch, args.seq)
    out = trainer.run(stream)
    stream.close()
    losses = out["losses"]
    summary = {
        "arch": cfg.name, "steps": out["steps"],
        "loss_first": losses[0], "loss_last": losses[-1],
        "mean_step_time_s": out["mean_step_time"],
        "straggler_events": out["straggler_events"],
    }
    print(json.dumps(summary, indent=1))
    if args.trace:
        tracer.save_jsonl(args.trace)
        print(f"trace written to {args.trace}")
    return summary


if __name__ == "__main__":
    main()
