"""Check and time the trace path's record kernels on the card.

    PYTHONPATH=src python -m repro_torch.launch.trace_bench
    python -m repro_torch.launch.trace_bench --trees old . . old

It builds the trace the trace path reads at main-10M (``big_events``,
64 ranks x 156,250 events, seed 0) and runs ``flat_profile``,
``time_profile``, ``load_imbalance`` and ``message_histogram`` on the CPU
path once, keeping the records each hands to ``seg_sum``, ``time_bin``,
``pair_sum`` and ``hist_bin`` (canonical order, as on the card).  Then,
for each checkout, it builds the kernels, prints what ``ptxas`` said about
the record kernels (registers, spills), holds each kernel's two paths
(:data:`PATHS`) against its plain version on those records
(``cardcheck.gate``; ``hist_bin``'s counts exact; bit-identical on
relaunch), and times both paths: device time from ``torch.profiler`` (the
kernels one call launches) and CUDA events around back-to-back calls, the
median of three runs.  It exits non-zero on a failed check or without a
card.

``--trees A B ...`` runs the checks and times in one process per checkout,
in the order given, on the same records (kept in this tree's build
directory), so that two versions of a kernel are compared on one card in
one call: for example an unpacked parent commit, then this tree twice,
then the parent again.  A tree whose kernel has one path (no
``<kernel>_path``, as before the private or narrow paths) is run through
its wrapper, under the name of that one path's design (``sorted``, or
``wide``).  Each
process keeps its outputs, and a last ``[bits]`` line per kernel and path
says whether every tree gave the same bits on the same records.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import torch

try:
    from .cardcheck import (card_line, cuda_ms, device_ms, exact, gate,
                            ptxas, run_trees, same_bits, short_name)
except ImportError:    # run as a script beside another checkout's package
    from cardcheck import (card_line, cuda_ms, device_ms, exact, gate,
                           ptxas, run_trees, same_bits, short_name)

__all__ = ["MAIN", "capture", "main"]

#: the trace path's main-10M trace (chip_smoke.py's MAIN)
MAIN = dict(nprocs=64, events_per_proc=156_250, seed=0)
#: each record kernel's (op, keyword arguments) on the trace path, whose
#: first call of the kernel is kept
OPS = {"seg_sum": ("flat_profile", {"metrics": ("time.exc", "time.inc")}),
       "time_bin": ("time_profile", {"num_bins": 32}),
       "pair_sum": ("load_imbalance", {}),
       "hist_bin": ("message_histogram", {"bins": 10})}
#: each record kernel's two paths; the last is the design of a tree that
#: has only one
PATHS = {"seg_sum": ("private", "sorted"), "time_bin": ("private", "sorted"),
         "pair_sum": ("private", "sorted"), "hist_bin": ("narrow", "wide")}
KERNELS = tuple(PATHS)


def capture(path: Path, names=KERNELS) -> None:
    """Run the :data:`OPS` of the kernels ``names`` on the CPU path of the
    main-10M trace and save the first call's arguments of each record
    kernel to ``path``."""
    from .. import Trace, kernels
    from ..tracegen import big_events
    trace = Trace.from_events(big_events(**MAIN), device="cpu")
    kept, orig = {}, {}
    for name in KERNELS:
        mod = getattr(kernels, name)
        orig[name] = fn = getattr(mod, name)

        def keep(*args, _fn=fn, _name=name, **kw):
            kept.setdefault(_name, (args, kw))
            return _fn(*args, **kw)
        setattr(mod, name, keep)
    try:
        for name in names:
            op, kw = OPS[name]
            trace.run(op, device="cpu", **kw)
    finally:
        for name, fn in orig.items():
            setattr(getattr(kernels, name), name, fn)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(kept, path)


def run(inputs: Path, iters: int, out: Path, names=KERNELS) -> int:
    """Check and time the kernels of the ``repro_torch`` on the path (the
    tree's own) on the records in ``inputs``; save the outputs to
    ``out``."""
    import repro_torch.kernels as kernels
    from repro_torch.kernels import build
    build.library()
    print(f"== {os.getcwd()}: build {build.BUILD_SECONDS:.1f} s", flush=True)
    for m, regs in ptxas(build.BUILD_LOG,
                         r"((?:seg|time|pair)_private|hist_narrow)I(\w*?)EEv"):
        print(f"[ptxas] {m.group(1)}<{m.group(2)}>: {regs}", flush=True)
    kept = torch.load(inputs)
    bad, outs = 0, {}
    for name in names:
        mod = getattr(kernels, name)
        args, kw = kept[name]
        args = tuple(a.cuda() if isinstance(a, torch.Tensor) else a
                     for a in args)
        want = getattr(mod, name + "_plain")(*args, **kw)
        shape = [tuple(a.shape) if isinstance(a, torch.Tensor) else a
                 for a in args] + sorted(kw.items())
        by_path = getattr(mod, name + "_path", None)
        check = exact if name == "hist_bin" else gate
        for p in PATHS[name]:
            if by_path is None and p != PATHS[name][-1]:
                continue                      # a tree with one path

            def call(_p=p):
                if by_path is None:
                    return getattr(mod, name)(*args, **kw)
                return by_path(_p, *args, **kw)
            got, again = call(), call()
            torch.cuda.synchronize()
            same = same_bits(got, again)
            try:
                err = check(got, want)
            except AssertionError as exc:
                err, same = str(exc), False
            bad += not same
            outs[f"{name} {p}"] = got.cpu()
            total, parts = sorted((device_ms(call, iters) for _ in range(3)),
                                  key=lambda d: d[0])[1]
            ev = sorted(cuda_ms(call, iters, warm=5) for _ in range(3))[1]
            print(f"[time] {name} {p:7s} device {total:.4f} ms ("
                  + ", ".join(f"{short_name(k)} {v:.4f}" for k, v in
                              parts.items())
                  + f"), events {ev:.4f} ms | {'ok ' if same else 'BAD'} "
                  f"max_abs_err {err} | {shape}", flush=True)
    torch.save(outs, out)
    return 1 if bad else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", metavar="DIR",
                    help="checkouts to run in turn, one process each")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--kernels", nargs="+", choices=KERNELS, default=KERNELS,
                    help="the record kernels to check and time (all)")
    ap.add_argument("--inputs", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_bench: no CUDA device", file=sys.stderr)
        return 2
    if args.inputs:
        return run(args.inputs, args.iters, args.out, args.kernels)
    print(card_line(), flush=True)
    from ..kernels import build
    inputs = build.BUILD_DIR / "trace_bench_inputs.pt"
    capture(inputs, args.kernels)
    trees = args.trees or ["."]
    outs = [build.BUILD_DIR / f"trace_bench_out_{i}.pt"
            for i in range(len(trees))]
    rc = 0
    for tree, out in zip(trees, outs):     # this file, that tree's package
        out.unlink(missing_ok=True)
        rc |= run_trees([tree], [
            sys.executable, os.path.abspath(__file__), "--iters",
            str(args.iters), "--kernels", *args.kernels, "--inputs",
            str(inputs), "--out", str(out)])
    got = [torch.load(p) if p.exists() else {} for p in outs]
    for key in sorted(set().union(*got)):
        have = [i for i, g in enumerate(got) if key in g]
        same = all(same_bits(got[i][key], got[have[0]][key]) for i in have)
        print(f"[bits] {key}: {'the same' if same else 'DIFFERENT'} bits "
              f"in trees {have} of {trees}", flush=True)
    return rc

if __name__ == "__main__":
    sys.exit(main())
