"""Check and time the flash-attention kernels on the card.

    PYTHONPATH=src python -m repro_torch.launch.flash_bench
    python -m repro_torch.launch.flash_bench --trees old . . old

Without ``--trees`` it builds this checkout's kernels, prints the card's
name and power limit and what ``ptxas`` said about the flash kernels
(registers, spills, and any advisory such as a serialized ``wgmma``),
holds the tensor-core kernel against the plain version on the bf16 cases
of the tests (within 3e-2, bit-identical on relaunch), and times it
beside ``scaled_dot_product_attention`` at the serving shape and a few
longer ones (CUDA events around back-to-back calls, best of three runs),
the SIMT kernel at the serving shape too.  It exits non-zero on a failed
check or without a card.

``--trees A B ...`` runs the same in one process per checkout, in the
order given (each with its own ``src`` and build directory), so that two
versions of a kernel are compared on one card in one call: for example an
unpacked parent commit, then this tree twice, then the parent again.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from .cardcheck import card_line, cuda_ms, ptxas, run_trees, same_bits

__all__ = ["CASES", "SHAPES", "main"]

#: bf16 cases of the tests: (B, Sq, Sk, H, KVH, D, keyword arguments)
CASES = [
    (1, 256, 256, 2, 2, 64, {}),
    (2, 200, 200, 8, 2, 128, {}),
    (1, 1000, 1000, 4, 4, 128, {}),
    (2, 50, 70, 4, 4, 64, {"causal": False, "window": 20}),
    (1, 40, 1300, 4, 2, 64, {"q_offset": 1260, "window": 64,
                             "prefix_len": 8}),
    (2, 1024, 1024, 4, 4, 128, {"window": 64, "prefix_len": 8}),
    (4, 1, 2000, 16, 16, 128, {"q_offset": 1999}),
    (2, 512, 700, 8, 8, 128, {"causal": False}),
    (1, 77, 200, 4, 4, 64, {"causal": False}),
    (4, 872, 872, 16, 16, 128, {}),
]
#: timed q = k = v shapes [B, S, H, D] and causality; the first two are
#: the serving path's two prefill waves
SHAPES = [((4, 872, 16, 128), True), ((4, 958, 16, 128), True),
          ((2, 4096, 16, 128), True), ((2, 4096, 16, 128), False),
          ((4, 2048, 16, 64), True)]


def run(iters: int) -> int:
    from ..kernels import build
    from ..kernels import flash_attention as fa
    build.library()
    print(f"== {os.getcwd()}: build {build.BUILD_SECONDS:.1f} s", flush=True)
    for m, regs in ptxas(build.BUILD_LOG,
                         r"(flash_wgmma|flash_fwd)I(\w*?)Li(\d+)E"):
        dtype = {"": "", "f": "f32, "}.get(m.group(2), "bf16, ")
        print(f"[ptxas] {m.group(1)}<{dtype}{m.group(3)}>: {regs}",
              flush=True)
    for line in build.BUILD_LOG.splitlines():
        if "(C75" in line:
            print(f"[ptxas] {line.strip()[:240]}", flush=True)
    rng = np.random.default_rng(0)
    bad = 0
    for B, Sq, Sk, H, KVH, D, kw in CASES:
        q, k, v = (torch.from_numpy(rng.standard_normal(s)
                                    .astype(np.float32))
                   .cuda().to(torch.bfloat16)
                   for s in ((B, Sq, H, D), (B, Sk, KVH, D),
                             (B, Sk, KVH, D)))
        got = fa.flash_attention_variant("wgmma", q, k, v, **kw)
        again = fa.flash_attention_variant("wgmma", q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        same = same_bits(got, again)
        ok = err <= 3e-2 and same
        bad += not ok
        print(f"[check] {'ok ' if ok else 'BAD'} {(B, Sq, Sk, H, KVH, D)} "
              f"{kw} max_abs_err {err:.4g} relaunch "
              f"{'bit-identical' if same else 'differs'}", flush=True)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for n, (shape, causal) in enumerate(SHAPES):
        q, k, v = (torch.randn(shape, device="cuda", dtype=torch.bfloat16)
                   for _ in range(3))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        B, S, H, D = shape
        flops = 4 * B * H * D * (S * (S + 1) / 2 if causal else S * S)
        times = {
            "wgmma": lambda: fa.flash_attention_variant(
                "wgmma", q, k, v, causal=causal),
            "sdpa": lambda: sdpa(qt, kt, vt, is_causal=causal)}
        if n == 0:
            times["simt"] = lambda: fa.flash_attention_variant(
                "simt", q, k, v, causal=causal)
        best = {name: min(cuda_ms(fn, iters, warm=5)
                          for _ in range(3))
                for name, fn in times.items()}
        print(f"[time] {list(shape)} causal={causal}: " + ", ".join(
            f"{name} {t:.4f} ms ({flops / t / 1e9:.0f} TFLOP/s)"
            for name, t in best.items()), flush=True)
    return 1 if bad else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", metavar="DIR",
                    help="checkouts to run in turn, one process each")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_bench: no CUDA device", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    if not args.trees:
        return run(args.iters)
    return run_trees(args.trees, [
        sys.executable, "-m", "repro_torch.launch.flash_bench", "--iters",
        str(args.iters)])


if __name__ == "__main__":
    sys.exit(main())
