"""Serving launcher: batched prefill+decode over a synthetic request queue.

Mirrors :mod:`repro.launch.serve`, on the card unless ``--device cpu``::

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch qwen2-moe-a2.7b --dtype bfloat16 --requests 8 --batch 4 \\
        --prompt-len 1024 --new-tokens 16 --cache-len 2048

The weights are random, drawn from seed 0.  Prompt lengths and tokens
come from ``np.random.default_rng(0)`` in the reference's order.  The
body is :func:`serve`, which returns the summary with the engine, the
finished requests and the tracer.  The command line is the reference's;
the encoder-decoder and the VLM need their extra inputs, which
:func:`serve` takes as ``extras`` (``{"frames": [batch, enc_frames,
d_model]}`` or ``{"img_embeds": [batch, img_tokens, d_model]}``, on the
engine's device) and hands to every wave's prefill.  ``overrides`` (the
CLI's ``--layers``) replaces config fields: the card serves
qwen1.5-110b and qwen3-moe-235b-a22b at full width with their depth cut.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..runtime import Tracer
from ..serving import Request, ServeEngine

__all__ = ["serve", "ServeRun", "make_requests", "main"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class ServeRun:
    summary: dict
    engine: ServeEngine
    done: List[Request]
    tracer: Tracer


def make_requests(vocab: int, n: int, prompt_len: int,
                  new_tokens: int) -> List[Request]:
    """The launcher's synthetic queue: lengths in [4, prompt_len], tokens
    in [0, vocab), drawn as the reference launcher draws them."""
    rng = np.random.default_rng(0)
    return [Request(i, rng.integers(0, vocab,
                                    rng.integers(4, prompt_len + 1),
                                    dtype=np.int32).astype(np.int32),
                    max_new_tokens=new_tokens)
            for i in range(n)]


def serve(arch: str = "qwen2-moe-a2.7b", smoke: bool = False,
          requests: int = 8, batch: int = 4, prompt_len: int = 32,
          new_tokens: int = 16, cache_len: int = 128,
          dtype: str = "float32", device="cuda",
          logits_hook: Optional[Callable[[str, torch.Tensor], None]] = None,
          extras: Optional[Dict[str, torch.Tensor]] = None,
          overrides: Optional[dict] = None) -> ServeRun:
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    tracer = Tracer()
    eng = ServeEngine(cfg, batch=batch, cache_len=cache_len, tracer=tracer,
                      dtype=DTYPES[dtype], device=device)
    eng.logits_hook = logits_hook
    reqs = make_requests(cfg.vocab, requests, prompt_len, new_tokens)
    t0 = time.perf_counter()
    done = eng.serve_queue(reqs, **(extras or {}))
    dt = time.perf_counter() - t0
    toks = sum(len(r.out_tokens) for r in done)
    summary = {"arch": cfg.name, "requests": len(done),
               "generated_tokens": toks, "wall_s": round(dt, 3),
               "tok_per_s": round(toks / dt, 2)}
    return ServeRun(summary, eng, done, tracer)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-moe-a2.7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="float32")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", default=None)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (full width)")
    args = ap.parse_args(argv)
    run = serve(args.arch, smoke=args.smoke, requests=args.requests,
                batch=args.batch, prompt_len=args.prompt_len,
                new_tokens=args.new_tokens, cache_len=args.cache_len,
                dtype=args.dtype, device=args.device,
                overrides={"n_layers": args.layers} if args.layers else None)
    print(json.dumps(run.summary, indent=1))
    if args.trace:
        run.tracer.save_jsonl(args.trace)
        print(f"trace written to {args.trace}")


if __name__ == "__main__":
    main()
