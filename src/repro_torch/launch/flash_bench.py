"""Check and time the model kernels on the card: flash attention, its
backward, and the float32 router's ``topk_gating``.

    PYTHONPATH=src python -m repro_torch.launch.flash_bench
    python -m repro_torch.launch.flash_bench --trees old . . old

Without ``--trees`` it builds this checkout's kernels, prints the card's
name and power limit and what ``ptxas`` said about the flash and top-k
kernels (registers, spills, and any advisory such as a serialized
``wgmma``), holds the tensor-core kernel against the plain version on the
bf16 cases of the tests (within 3e-2, bit-identical on relaunch), and times
it beside ``scaled_dot_product_attention`` at the serving shape and a few
longer ones (CUDA events around back-to-back calls, best of three runs),
the SIMT kernel at the serving shape too.  Then the backward (q/k/v/o/dO
bf16, causal) at the training shape [16, 256, 12, 64] and at
[2, 4096, 16, 128], on the plain forward's output and log-sum-exp, through
each variant the tree has (``"wgmma"`` and ``"simt"``; a tree with one
runs its wrapper, the SIMT design): each gradient within
``flash_bwd_tol`` of the plain version, bit-identical on relaunch, device
time from ``torch.profiler`` (the median of three profiles) beside SDPA's
backward (``torch.autograd.grad`` through
``scaled_dot_product_attention``, device time the same way); and the SIMT
backward in float32 at the training shape (checked, its bits saved).
``ptxas``'s registers and spills are printed for the backward kernels too.
Then ``topk_gating`` at the f32
router's shape (T = 3,488, E = 60, k = 4, logits ~ N(0, 1) from seed 0,
as ``moe_ffn``'s router product gives them) through both of its paths:
indices exact and gates within 1e-6 of the plain version, bit-identical on
relaunch, device time from ``torch.profiler`` and CUDA events, the median
of three runs.  It exits non-zero on a failed check or without a card.

``--trees A B ...`` runs this file once per checkout, in the order given,
each process on that checkout's own ``src`` and build directory, so that
two versions of a kernel are compared on one card in one call: for example
an unpacked parent commit, then this tree twice, then the parent again.
A tree whose ``topk_gating`` has one path (no ``topk_gating_path``) runs
it through its wrapper, under the name of that design, ``wide``.  A last
``[bits]`` line per forward case, top-k path and backward variant, dtype
and shape says whether every tree that ran it gave the same bits.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np
import torch

try:
    from .cardcheck import (card_line, cuda_ms, device_ms, flash_bwd_tol,
                            ptxas, run_trees, same_bits, short_name)
except ImportError:    # run as a script beside another checkout's package
    from cardcheck import (card_line, cuda_ms, device_ms, flash_bwd_tol,
                           ptxas, run_trees, same_bits, short_name)

__all__ = ["CASES", "SHAPES", "BWD_SHAPES", "TOPK", "main"]

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
#: the backward's q = o = dO [B, S, H, D] and k = v [B, S, KVH, D], causal:
#: the training shape, and a long one at D = 128
BWD_SHAPES = [(16, 256, 12, 12, 64), (2, 4096, 16, 16, 128)]
#: the f32 router's top-k: (T, E, k) of chip_smoke.py's f32 moe_ffn call
TOPK = (3488, 60, 4)


def run(iters: int, out=None) -> int:
    """Check and time the kernels of the ``repro_torch`` on the path; save
    the top-k outputs to ``out`` when given."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    build.library()
    print(f"== {os.getcwd()}: build {build.BUILD_SECONDS:.1f} s", flush=True)
    for m, regs in ptxas(build.BUILD_LOG,
                         r"(flash_wgmma|flash_fwd|bwd_dkdv_wgmma|"
                         r"bwd_dq_wgmma|bwd_dkdv|bwd_dq|bwd_delta)"
                         r"I(\w*?)Li(\d+)E"):
        dtype = {"": "", "f": "f32, "}.get(m.group(2), "bf16, ")
        print(f"[ptxas] {m.group(1)}<{dtype}{m.group(3)}>: {regs}",
              flush=True)
    for m, regs in ptxas(build.BUILD_LOG,
                         r"(topk_narrow|topk_gate)I(\w*?)EEv"):
        print(f"[ptxas] {m.group(1)}<{m.group(2)}>: {regs}", flush=True)
    for line in build.BUILD_LOG.splitlines():
        if "(C75" in line:
            print(f"[ptxas] {line.strip()[:240]}", flush=True)
    rng = np.random.default_rng(0)
    bad, outs = 0, {}
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
        outs[f"flash_attention wgmma {(B, Sq, Sk, H, KVH, D)} {kw}"] = (
            got.cpu(),)
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
    bad += run_bwd(iters, outs)
    bad += run_topk(iters, outs)
    if out is not None:
        torch.save(outs, out)
    return 1 if bad else 0


def _median_device_ms(fn, iters):
    """The median of three ``device_ms`` profiles: (total ms, by kernel)."""
    return sorted((device_ms(fn, iters) for _ in range(3)),
                  key=lambda d: d[0])[1]


def run_bwd(iters: int, outs: dict) -> int:
    """The backward at :data:`BWD_SHAPES` through each variant the tree
    has, and the SIMT one in f32 at the training shape; each result saved
    to ``outs``.  Returns the number of failed checks."""
    from repro_torch.kernels import flash_attention as fa
    by_variant = getattr(fa, "flash_attention_bwd_variant", None)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rng = np.random.default_rng(1)
    bad = 0
    for dtype, (B, S, H, KVH, D) in [
            *((torch.bfloat16, s) for s in BWD_SHAPES),
            (torch.float32, BWD_SHAPES[0])]:
        q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).cuda().to(dtype) for s in (
                (B, S, H, D), (B, S, KVH, D), (B, S, KVH, D), (B, S, H, D)))
        o, lse = fa.flash_attention_plain(q, k, v, return_lse=True)
        o = o.contiguous()
        want = fa.flash_attention_bwd_plain(q, k, v, o, do, lse)
        tag = f"{str(dtype)[6:]} {[B, S, H, D]}"
        names = ("wgmma", "simt") if dtype == torch.bfloat16 and \
            by_variant is not None else ("simt",)
        for name in names:
            def call(_n=name):
                if by_variant is None:              # one design: SIMT
                    return fa.flash_attention_bwd(q, k, v, o, do, lse)
                return by_variant(_n, q, k, v, o, do, lse)
            got, again = call(), call()
            torch.cuda.synchronize()
            same = all(same_bits(a, b) for a, b in zip(got, again))
            err = {n: float((g.float() - w.float()).abs().max()) /
                   flash_bwd_tol(dtype, w)
                   for n, g, w in zip(("dq", "dk", "dv"), got, want)}
            ok = same and all(e <= 1 for e in err.values())
            bad += not ok
            outs[f"flash_attention_bwd {name} {tag}"] = tuple(
                x.cpu() for x in got)
            del got, again
            line = f"[bwd] {'ok ' if ok else 'BAD'} {name:5s} {tag} causal"
            if dtype == torch.bfloat16:
                total, parts = _median_device_ms(call, iters)
                line += f" device {total:.4f} ms (" + ", ".join(
                    f"{short_name(n)} {t:.4f}" for n, t in parts.items()) \
                    + ")"
            print(line + " | err / gate " + ", ".join(
                f"{n} {e:.3f}" for n, e in err.items()) + " | relaunch "
                + ("bit-identical" if same else "differs"), flush=True)
        if dtype == torch.bfloat16:
            qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                          for x in (q, k, v))
            with torch.enable_grad():
                out_t = sdpa(qt, kt, vt, is_causal=True)
            do_t = do.transpose(1, 2).contiguous()
            total, _parts = _median_device_ms(lambda: torch.autograd.grad(
                out_t, (qt, kt, vt), do_t, retain_graph=True), iters)
            print(f"[bwd] sdpa  {tag} causal device {total:.4f} ms",
                  flush=True)
            del qt, kt, vt, out_t, do_t
        del q, k, v, do, o, lse, want
        torch.cuda.empty_cache()
    return bad


def run_topk(iters: int, outs: dict) -> int:
    """The f32 router's top-k (:data:`TOPK`) through each path the tree's
    ``topk_gating`` has, each result saved to ``outs``; the number of
    failed checks."""
    from repro_torch.kernels import topk_gating as tg
    T, E, k = TOPK
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (T, E)).astype(np.float32)).cuda()
    want_idx, want_gates = tg.topk_gating_plain(logits, k)
    by_path = getattr(tg, "topk_gating_path", None)
    bad = 0
    for p in ("narrow", "wide"):
        if by_path is None and p != "wide":
            continue                          # a tree with one path

        def call(_p=p):
            if by_path is None:
                return tg.topk_gating(logits, k)
            return by_path(_p, logits, k)
        got, again = call(), call()
        torch.cuda.synchronize()
        same = all(same_bits(a, b) for a, b in zip(got, again))
        err = float((got[1] - want_gates).abs().max())
        ok = same and torch.equal(got[0], want_idx) and err <= 1e-6
        bad += not ok
        outs[f"topk_gating {p}"] = tuple(x.cpu() for x in got)
        total, parts = _median_device_ms(call, iters)
        ev = sorted(cuda_ms(call, iters, warm=5) for _ in range(3))[1]
        print(f"[time] topk_gating {p:6s} device {total:.4f} ms ("
              + ", ".join(f"{short_name(name)} {v:.4f}"
                          for name, v in parts.items())
              + f"), events {ev:.4f} ms | {'ok ' if ok else 'BAD'} indices "
              f"{'exact' if torch.equal(got[0], want_idx) else 'DIFFER'}, "
              f"gates max_abs_err {err:.3g} | T={T} E={E} k={k}", flush=True)
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", metavar="DIR",
                    help="checkouts to run in turn, one process each")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--out", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_bench: no CUDA device", file=sys.stderr)
        return 2
    if not args.trees:
        if args.out is None:
            print(card_line(), flush=True)
        return run(args.iters, args.out)
    print(card_line(), flush=True)
    from repro_torch.kernels import build
    outs = [build.BUILD_DIR / f"flash_bench_out_{i}.pt"
            for i in range(len(args.trees))]
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)   # before any tree
    rc = 0
    for tree, out in zip(args.trees, outs):   # this file, that tree's package
        out.unlink(missing_ok=True)
        rc |= run_trees([tree], [
            sys.executable, os.path.abspath(__file__), "--iters",
            str(args.iters), "--out", str(out)])
    got = [torch.load(p) if p.exists() else {} for p in outs]
    for key in sorted(set().union(*got)):
        have = [i for i, g in enumerate(got) if key in g]
        same = all(same_bits(a, b) for i in have
                   for a, b in zip(got[i][key], got[have[0]][key]))
        print(f"[bits] {key}: {'the same' if same else 'DIFFERENT'} bits "
              f"in trees {have} of {args.trees}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
