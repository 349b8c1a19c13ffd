"""Drive the PyTorch + CUDA port's paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. device  — name, count and ``nvidia-smi`` name / power limit;
2. build   — compile every ``src/repro_torch/csrc/*.cu`` for sm_90a and
             print the ptxas register / shared-memory / spill lines;
3. kernels — each kernel against its plain PyTorch version on the card at
             its path's shapes, wider shapes and edge cases, and
             bit-identical on relaunch (the trace kernels; ``seg_sum``,
             ``pair_sum`` and ``time_bin`` through the path the wrapper
             picks and, up to 6,144 cells, also through the sorted one:
             ignored records, runs, K = 1, 3, 8 and 11, the threshold's
             two sides, large grids, NaN and infinite coordinates for
             ``time_bin``; flash attention in bf16
             and f32 with causal, window + prefix, non-causal, GQA,
             padded-tail and one-query cases, each bf16 case at D = 64 or
             128 through both kernel variants, the tensor-core one the
             wrapper picks and the SIMT one; ``hist_bin`` through its
             narrow path (up to 32 bins) and its wide one, counts exact, on
             +inf, 3e9, -0.0, NaN and -inf coordinates, N = 1, N not a
             multiple of 4 and coordinates off the 16-byte boundary; top-k
             through its narrow path (E up to 128) and its wide one, each
             exact against the plain version and the two bit for bit, at
             the serving shape, E = 5, 33, 64, 127, 128, 129 and 300, k = 1
             to 8, ragged T, exact ties and rows of -inf or at or below
             -1e30 (a row holding NaN is logged only); the fused router
             at the serving model's prefill and decode shapes, E = 128
             with k = 8, a ragged depth with odd E, all-zero rows, and a
             depth split over a cluster at odd E);
4. reader  — a small ``big_trace`` jsonl trace through ``Trace.open`` and
             the six ops on the card and on the CPU;
5. main    — the trace path: 10M events over 64 ranks (``big_trace``
             parameters, seed 0): structure, then the seven op calls of
             the six ops (``stragglers`` at a threshold of -1, every
             rank) on the card, each held against the CPU path; the trace
             kernels' launch counts (and those of ``seg_sum``, ``pair_sum``
             and ``time_bin`` by path) are reset just before and read just
             after: each must have risen, every call of the three must
             have taken the private path and ``hist_bin``'s its narrow
             path;
6. query   — lazy plans over the same in-memory trace on the card:
             ``trace.query().filter(Name not-in [MpiSend])
             .restrict_processes(range(32))`` (structure remapped) and
             each op, then ``filter(Name not-in [halo_exchange()])``
             (structure recomputed) and the two message ops; each result
             the bits of the same selection made eagerly and reduced on
             the card; ``stragglers`` on the whole trace and the first
             plan within the gate of the CPU path; counts reset before the
             plans and read after them, as in phase 5;
7. stream  — ``Trace.open(paths, streaming=True, chunk_rows=65_536)``
             over ``big_trace`` jsonl shards (64 ranks x 15,625 events,
             about 1.0M, in a temporary directory) on the card: each op
             the bits of ``Trace.open(paths)`` on the card and within the
             gate of the CPU streaming route, counts as in phase 5; three
             op calls again at 4,999 rows a chunk, which splits calls
             across chunks, again the eager bits;
8. timing  — each trace kernel on the inputs the trace path gave it (its
             first call, and in ``other_calls`` each later call of another
             shape: ``stragglers``' ``seg_sum`` at K = 1 over 64 ranks,
             ``comm_matrix``'s ``pair_sum`` at 64 x 64): its
             time, its plain version's, one library call's (for
             ``time_bin`` a chain of calls), and its bound; a private-path
             row also times the sorted path on the same inputs and fails
             if its profiler row holds a sort kernel, the ``hist_bin`` row
             the wide path, and fails unless the narrow path is one device
             kernel a call;
9. serve   — the serving path: ``repro_torch.launch.serve`` serves 8
             requests (prompts up to 1024 tokens, 16 new tokens, batch 4,
             cache 2048) on qwen2-moe-a2.7b at full width, all 24 layers,
             bf16 weights drawn from seed 0 on the card; the model
             kernels' counts are reset just before and read just after,
             and each of the path's must have risen, every flash launch
             on the tensor-core variant and every router call (24 layers
             x 16 steps x 2 waves) on the fused ``router_topk`` kernel,
             none on ``topk_gating``; tokens in the vocabulary, finite
             logits, and the run's own trace through ``flat_profile`` on
             the card; then one prefill and one decode step under
             ``torch.profiler`` (device busy share, the largest kernels);
10. f32    — one ``moe_ffn`` call in float32 at the serving model's
             widths (3,488 tokens, the first wave's prefill): the unfused
             route, so ``topk_gating`` is launched once, on its narrow
             path, and ``router_topk`` not at all (counts reset just
             before);
11. path   — qwen2-moe-smoke in f32 with one seeded weight set served on
             the card (kernels) and on the CPU (plain versions): the same
             greedy tokens, prefill logits within 1e-3;
12. timing — each model kernel on the inputs its path gave it, against
             its plain version, with one library call and its bound;
             flash attention also through its SIMT variant (``prev_ms``,
             the kernel this one replaced on the path); the fused router
             also at the decode shape and beside the unfused route it
             replaced (``prev_ms``: the f32 product + ``topk_gating``);
             ``topk_gating`` also through its wide path on the same logits
             (the same bits, ``prev_ms``).

Every row's ``ms`` is CUDA events around back-to-back wrapper calls (host
overhead included where the kernel is shorter than the call);
``device_ms`` is the summed duration of the device kernels one wrapper
call launches, read from ``torch.profiler``.  The rows of ``seg_sum``,
``pair_sum``, ``time_bin``, ``hist_bin`` and ``topk_gating`` name their
``path`` and time the path it replaced on the same inputs (``prev_path``,
``prev_ms``, ``prev_device_ms``); the four trace rows also give their
launches on the query and stream routes (``route_launches``).

It prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``.  It imports nothing of the JAX
reference package.  Without a CUDA device it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
from repro_torch.launch.cardcheck import (  # noqa: E402
    card_line, cuda_ms, device_ms, exact, gate, same_bits)

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
MAIN = dict(nprocs=64, events_per_proc=156_250, seed=0)
ARCH = "qwen2-moe-a2.7b"
SERVE = dict(arch=ARCH, requests=8, batch=4, prompt_len=1024,
             new_tokens=16, cache_len=2048, dtype="bfloat16")


def log(*parts) -> None:
    print(*parts, flush=True)


# ---------------------------------------------------------------------------
# phases 1-2
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = card_line()
    log(f"[device] {name} x{count}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(smi)
    return {"kind": name, "count": count, "smi": smi}


def phase_build() -> None:
    from repro_torch.kernels import build
    build.library()
    log(f"[build] {build.BUILD_SECONDS:.2f} s into {build.BUILD_DIR}")
    for line in build.BUILD_LOG.splitlines():
        if any(k in line for k in ("==", "Compiling entry", "registers",
                                   "spill", "smem")):
            log("[ptxas]", line.strip())


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain versions on the card
# ---------------------------------------------------------------------------

def _dev(x):
    return torch.from_numpy(np.ascontiguousarray(x)).cuda()


def _seg_case(rng, n, n_seg, k, pad=0.0, runs=False):
    code = rng.integers(0, n_seg, size=n).astype(np.int32)
    code[rng.random(n) < pad] = -1
    if runs:                     # long runs of one code
        code = np.sort(code)
    vals = rng.integers(5_000, 40_000, size=(n, k)).astype(np.float32)
    return _dev(code), _dev(vals), n_seg


def _pair_case(rng, n, n_a, n_b, pad=0.0, runs=False):
    a = rng.integers(0, n_a, size=n).astype(np.int32)
    b = rng.integers(0, n_b, size=n).astype(np.int32)
    a[rng.random(n) < pad] = -1
    if runs:                     # by rank, then name: the ops' long runs
        o = np.lexsort((a, b))
        a, b = a[o], b[o]
    w = rng.integers(256, 8192, size=n).astype(np.float32)
    return _dev(a), _dev(b), _dev(w), n_a, n_b


def _time_case(rng, n, n_funcs, n_bins, zero=0.0, pad=0.0, runs=False,
               nonfinite=False):
    s = rng.random(n) * n_bins
    d = rng.exponential(2e-3, size=n)
    d[rng.random(n) < 0.001] *= 5000           # a few long calls
    d[rng.random(n) < zero] = 0.0              # zero-duration calls
    if runs:                                   # canonical order: by start
        s = np.sort(s)
    e = np.minimum(s + d, n_bins)
    f = rng.integers(0, n_funcs, size=n).astype(np.int32)
    f[rng.random(n) < pad] = -1
    r = (rng.integers(5_000, 40_000, size=n) / np.maximum(d, 1e-9)
         * (d > 0))
    s, e, r = s.astype(np.float32), e.astype(np.float32), \
        (r * 1e-6).astype(np.float32)
    if nonfinite:          # infinite ends clamp; NaN fills func 1's row
        s[::1001], e[::1003] = -np.inf, np.inf
        s[5::2003], e[7::2003] = np.inf, -np.inf
        s[11::20011] = np.nan
        e[13::30011] = np.nan
        f[11::20011] = f[13::30011] = 1
    return (_dev(s), _dev(e), _dev(f), _dev(r), n_funcs, n_bins, 0.0,
            float(n_bins))


def _hist_case(rng, n, n_bins, pad=0.0, edges=False, offset=0):
    """``offset`` > 0 starts the coordinates that many floats past a
    16-byte boundary (the narrow path's scalar head)."""
    x = rng.integers(0, n_bins, size=n + offset) + 0.5
    x[rng.random(n + offset) < pad] = -1.0
    if edges:         # +inf and 3e9 in the top bin, -0.0 in bin 0, NaN and
        x[1::17], x[2::17], x[3::17] = np.inf, 3e9, -0.0       # -inf out
        x[4::17], x[5::17] = np.nan, -np.inf
    return _dev(x.astype(np.float32))[offset:], n_bins


def phase_kernels() -> None:
    """The trace kernels: ``seg_sum``, ``time_bin`` and ``pair_sum`` case by
    case through :func:`check_paths`, ``hist_bin`` through the path its
    wrapper picks and the wide one against its plain version (counts
    exact, bit-identical on relaunch)."""
    from repro_torch.kernels import hist_bin
    rng = np.random.default_rng(0)
    paths = {
        "seg_sum": [
            ("main 4.3M x2, 6 names", _seg_case(rng, 4_300_000, 6, 2)),
            ("1024 names", _seg_case(rng, 4_300_000, 1024, 1)),
            ("N=1", _seg_case(rng, 1, 5, 2)),
            ("N=1000, padded", _seg_case(rng, 1000, 7, 3, pad=0.2)),
            ("all codes < 0", _seg_case(rng, 5000, 7, 1, pad=1.0)),
            ("K=11", _seg_case(rng, 20_000, 9, 11)),
            ("K=8", _seg_case(rng, 200_000, 6, 8)),
            ("6 names x2, in runs", _seg_case(rng, 4_300_000, 6, 2,
                                              runs=True)),
            ("threshold 3072 x 2", _seg_case(rng, 500_000, 3072, 2)),
            ("above it, 6145 names", _seg_case(rng, 500_000, 6145, 1)),
        ],
        "time_bin": [
            ("main 4.3M, 32 bins", _time_case(rng, 4_300_000, 6, 32)),
            ("1024 bins", _time_case(rng, 500_000, 13, 1024)),
            ("N=1", _time_case(rng, 1, 3, 8)),
            ("N=1000, zero-duration", _time_case(rng, 1000, 7, 10,
                                                 zero=0.3, pad=0.1)),
            ("all funcs < 0", _time_case(rng, 5000, 7, 10, pad=1.0)),
            ("32 bins, in runs", _time_case(rng, 4_300_000, 6, 32,
                                            runs=True)),
            ("NaN and inf coordinates", _time_case(rng, 500_000, 6, 32,
                                                   nonfinite=True)),
            ("threshold 48 x 128", _time_case(rng, 500_000, 48, 128)),
            ("above it, 5 x 1229", _time_case(rng, 500_000, 5, 1229)),
        ],
    }
    hist = [
        ("main 0.7M, 10 bins", _hist_case(rng, 700_000, 10)),
        ("1024 bins", _hist_case(rng, 700_000, 1024)),
        ("20000 bins", _hist_case(rng, 700_000, 20_000)),
        ("N=1", _hist_case(rng, 1, 4)),
        ("N=1000, padded", _hist_case(rng, 1000, 7, pad=0.2)),
        ("all < 0", _hist_case(rng, 5000, 7, pad=1.0)),
        ("+inf 3e9 -0.0 NaN, N=500003", _hist_case(rng, 500_003, 10,
                                                   edges=True)),
        ("edges, N=7", _hist_case(rng, 7, 3, edges=True)),
        ("N=1, +inf", (_dev(np.array([np.inf], np.float32)), 5)),
        ("N=1, -0.0", (_dev(np.array([-0.0], np.float32)), 5)),
        ("N=1, NaN", (_dev(np.array([np.nan], np.float32)), 5)),
        ("N=2, off 16 bytes", _hist_case(rng, 2, 6, offset=1)),
        ("N=100001, off 16 bytes", _hist_case(rng, 100_001, 10, edges=True,
                                              offset=3)),
        ("32 bins", _hist_case(rng, 700_000, 32)),
        ("33 bins", _hist_case(rng, 700_000, 33)),
        ("1 bin", _hist_case(rng, 70_000, 1, pad=0.1)),
    ]
    rng = np.random.default_rng(2)
    paths["pair_sum"] = [
        ("main ranks x ranks 0.7M", _pair_case(rng, 700_000, 64, 64)),
        ("main names x ranks 4.3M", _pair_case(rng, 4_300_000, 6, 64)),
        ("names x ranks, in runs", _pair_case(rng, 4_300_000, 6, 64,
                                              runs=True)),
        ("64 x 64, 30% ignored", _pair_case(rng, 700_000, 64, 64,
                                            pad=0.3)),
        ("threshold 96 x 64", _pair_case(rng, 1_000_000, 96, 64)),
        ("above it, 5 x 1229", _pair_case(rng, 1_000_000, 5, 1229)),
        ("1024 x 1024", _pair_case(rng, 4_300_000, 1024, 1024)),
        ("2048 x 2048", _pair_case(rng, 4_300_000, 2048, 2048)),
        ("2048 x 2048, 30% ignored", _pair_case(rng, 4_300_000, 2048, 2048,
                                                pad=0.3)),
        ("N=1", _pair_case(rng, 1, 3, 3)),
        ("N=1000, padded", _pair_case(rng, 1000, 5, 7, pad=0.2)),
        ("all codes < 0", _pair_case(rng, 5000, 5, 7, pad=1.0)),
    ]
    for name, items in paths.items():
        for label, args in items:
            check_paths(name, label, args)
        if PATHS_SEEN[name] != {"private", "sorted"}:
            raise AssertionError(f"{name} paths checked {PATHS_SEEN[name]}")
    seen = set()
    for label, args in hist:
        picked = hist_bin.path(args[1])
        want = hist_bin.hist_bin_plain(*args).cpu().numpy()
        for p in dict.fromkeys((picked, "wide")):
            got = hist_bin.hist_bin_path(p, *args)
            again = hist_bin.hist_bin_path(p, *args)
            torch.cuda.synchronize()
            if not same_bits(got, again):
                raise AssertionError(f"hist_bin [{label}, {p}]: relaunch "
                                     f"differs")
            exact(got.cpu().numpy(), want)
            seen.add(p)
            log(f"[kernels] hist_bin {label:28s} {p:6s}"
                f"{' (picked)' if p == picked else '         '} ok  counts "
                f"exact  bit-identical relaunch")
    if seen != set(hist_bin.PATH_LAUNCHES):
        raise AssertionError(f"hist_bin paths checked {seen}")


#: the kernels with a private and a sorted path, and the paths checked
PATH_KERNELS = ("seg_sum", "pair_sum", "time_bin")
PATHS_SEEN = {name: set() for name in PATH_KERNELS}
#: the path every main-path call of a trace kernel must take
MAIN_PATHS = {"seg_sum": "private", "pair_sum": "private",
              "time_bin": "private", "hist_bin": "narrow"}
#: the design each path replaced on its path: timed on the same inputs
PREV_PATH = {"private": "sorted", "narrow": "wide"}


def _n_cells(name, args) -> tuple:
    """(records, grid cells) of a path kernel's positional arguments."""
    if name == "seg_sum":
        return args[0].shape[0], args[2] * args[1].shape[1]
    if name == "pair_sum":
        return args[0].shape[0], args[3] * args[4]
    return args[0].shape[0], args[4] * args[5]


def check_paths(name, label, args) -> None:
    """A path kernel through the path its wrapper picks and, where the grid
    fits the private path, also through the sorted one: each bit-identical
    on relaunch and within the gate of the plain version."""
    from repro_torch import kernels
    mod = getattr(kernels, name)
    run, plain = getattr(mod, name + "_path"), getattr(mod, name + "_plain")
    picked = mod.path(*_n_cells(name, args))
    want = plain(*args).cpu().numpy()
    for p in dict.fromkeys((picked, "sorted")):
        got = run(p, *args)
        again = run(p, *args)
        torch.cuda.synchronize()
        if not same_bits(got, again):
            raise AssertionError(f"{name} [{label}, {p}]: relaunch differs")
        err = gate(got.cpu().numpy(), want)
        PATHS_SEEN[name].add(p)
        log(f"[kernels] {name} {label:26s} {p:7s}"
            f"{' (picked)' if p == picked else '         '} ok  "
            f"max_abs_err={err:.6g}  bit-identical relaunch")


def _flash_case(rng, B, Sq, Sk, H, KVH, D, dtype, **kw):
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .cuda().to(dtype) for s in ((B, Sq, H, D), (B, Sk, KVH, D),
                                           (B, Sk, KVH, D)))
    return (q, k, v), kw


def _topk_case(rng, T, E, k, ties=False, fill=None):
    """``fill``: every other row set to that value (``-inf`` and values at
    or below -1e30 select a chosen column again), the rows between at or
    below -1e30 too."""
    x = rng.standard_normal((T, E)).astype(np.float32)
    if ties:
        x[::2, 3::4] = 2.5                   # exact ties among the largest
        x[1::2] = np.round(x[1::2])          # tied integers, signed zeros
    if fill is not None:
        x[::2] = fill
        x[1::2] = -1e30 - np.abs(x[1::2]) * 1e30
    return (_dev(x), k), {}


def _router_case(rng, T, d, E, k, zero_rows=False):
    """bf16 activations ~ N(0, 1) (what rms_norm hands the router) and a
    router weight drawn as the model draws it (std d^-1/2)."""
    x = rng.standard_normal((T, d)).astype(np.float32)
    if zero_rows:
        x[::7] = 0.0                 # all-zero logits: every expert ties
    w = (rng.standard_normal((d, E)) * d ** -0.5).astype(np.float32)
    return _dev(x).bfloat16(), _dev(w).bfloat16(), k


def check_router(label, x, w, k) -> float:
    """The fused router against its plain version on the card: bit-identical
    on relaunch; idx equal to and gates within 1e-6 of ``topk_gating_plain``
    on the kernel's own logits; logits within ``logit_tolerance`` of the
    float32 product; and every row whose indices differ from the plain
    route's must differ where two of the plain logits lie within twice
    that tolerance of each other (each may move by it).  Returns the
    logits' max abs error."""
    from repro_torch.kernels import router_topk as rt
    from repro_torch.kernels import topk_gating as tg
    got = rt.router_topk(x, w, k)
    again = rt.router_topk(x, w, k)
    want_logits, want_idx, _want_gates = rt.router_topk_plain(x, w, k)
    tol = rt.logit_tolerance(x, w)
    torch.cuda.synchronize()
    if not all(torch.equal(p, q) for p, q in zip(got, again)):
        raise AssertionError(f"router_topk [{label}]: relaunch differs")
    logits, idx, gates = got
    own_idx, own_gates = tg.topk_gating_plain(logits, k)
    exact(idx.cpu().numpy(), own_idx.cpu().numpy())
    gate_err = within(1e-6)(gates.cpu().numpy(), own_gates.cpu().numpy())
    diff = (logits - want_logits).abs()
    if not bool((diff <= tol).all()):
        raise AssertionError(f"router_topk [{label}]: logits outside the "
                             f"tolerance, max abs err {float(diff.max())}")
    err = float(diff.max())
    ratio = float((diff / tol.clamp_min(1e-30)).max())
    rows = (idx != want_idx).any(dim=1).nonzero().flatten()
    if len(rows):
        first = (idx[rows] != want_idx[rows]).int().argmax(dim=1)
        pl = want_logits[rows]
        a = pl.gather(1, want_idx[rows, first].long()[:, None])
        b = pl.gather(1, idx[rows, first].long()[:, None])
        gap = (a - b).abs().flatten()
        if not bool((gap <= 2 * tol[rows].amax(dim=1)).all()):
            raise AssertionError(f"router_topk [{label}]: {len(rows)} rows "
                                 f"route differently with logit gaps above "
                                 f"the tolerance")
    log(f"[kernels] router_topk {label:34s} ok  idx exact and gates "
        f"max_abs_err={gate_err:.3g} on its own logits; logits "
        f"max_abs_err={err:.3g} ({ratio:.3g} of the tolerance); "
        f"{len(rows)}/{len(idx)} rows route differently from the plain "
        f"logits, each within the tolerance; bit-identical relaunch")
    return err


def within(tol):
    """Max abs error of a kernel result against its plain version; raises
    above ``tol``."""
    def check(a, b):
        err = float(np.abs(np.asarray(a, np.float64)
                           - np.asarray(b, np.float64)).max()) \
            if np.asarray(a).size else 0.0
        if not err <= tol:
            raise AssertionError(f"max abs err {err} above {tol}")
        return err
    return check


def phase_model_kernels() -> None:
    """Flash attention within 2e-5 (f32) / 3e-2 (bf16) of its plain
    version, top-k indices exact and gates within 1e-6 (the tolerances of
    tests/test_kernels.py), the fused router as :func:`check_router`
    holds it; every case bit-identical on relaunch.  Each bf16 flash case
    at D = 64 or 128 runs through both variants: the tensor-core one (what
    the wrapper picks) and the SIMT one.  Each top-k case runs through the
    path the wrapper picks and the wide one, whose bits must be equal."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import topk_gating as tg
    rng = np.random.default_rng(1)
    flash = []
    for dtype, tol in ((torch.bfloat16, 3e-2), (torch.float32, 2e-5)):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        flash += [
            (f"{tag} serve 4x1024x16x128 causal", tol,
             _flash_case(rng, 4, 1024, 1024, 16, 16, 128, dtype)),
            (f"{tag} window 64 + prefix 8", tol,
             _flash_case(rng, 2, 1024, 1024, 16, 16, 128, dtype,
                         window=64, prefix_len=8)),
            (f"{tag} non-causal", tol,
             _flash_case(rng, 2, 512, 700, 8, 8, 128, dtype, causal=False)),
            (f"{tag} GQA H/KVH=4", tol,
             _flash_case(rng, 2, 512, 512, 16, 4, 128, dtype)),
            (f"{tag} padded tail S=1000", tol,
             _flash_case(rng, 2, 1000, 1000, 16, 16, 128, dtype)),
            (f"{tag} Sq=1 at position 1999", tol,
             _flash_case(rng, 4, 1, 2000, 16, 16, 128, dtype,
                         q_offset=1999)),
            (f"{tag} smoke width D=16", tol,
             _flash_case(rng, 4, 33, 33, 4, 4, 16, dtype)),
            (f"{tag} D=64 S=1000", tol,
             _flash_case(rng, 2, 1000, 1000, 8, 8, 64, dtype)),
            (f"{tag} D=64 GQA 4, window 64 + prefix 8", tol,
             _flash_case(rng, 1, 40, 1300, 8, 2, 64, dtype, q_offset=1260,
                         window=64, prefix_len=8)),
        ]
    topk = [
        ("serve T=4096 E=60 k=4", _topk_case(rng, 4096, 60, 4)),
        ("E=128 k=8", _topk_case(rng, 2048, 128, 8)),
        ("ragged T=4099", _topk_case(rng, 4099, 60, 4)),
        ("exact ties", _topk_case(rng, 4096, 60, 4, ties=True)),
        ("decode T=4", _topk_case(rng, 4, 60, 4)),
        ("rows of -inf", _topk_case(rng, 1000, 60, 4, fill=-np.inf)),
        ("rows at -1e30", _topk_case(rng, 1000, 60, 8, fill=-1e30)),
        ("E=5 k=1", _topk_case(rng, 3001, 5, 1, ties=True)),
        ("E=5 k=5", _topk_case(rng, 3001, 5, 5, ties=True)),
        ("E=33 k=8", _topk_case(rng, 3001, 33, 8, ties=True)),
        ("E=64 k=4", _topk_case(rng, 3001, 64, 4, ties=True)),
        ("E=127 k=8", _topk_case(rng, 3001, 127, 8, ties=True)),
        ("E=128 k=1", _topk_case(rng, 3001, 128, 1, ties=True)),
        ("E=129 k=8", _topk_case(rng, 1001, 129, 8, ties=True)),
        ("E=300 k=2", _topk_case(rng, 1001, 300, 2)),
    ]
    router = [
        ("serve prefill T=3488 d=2048 E=60 k=4",
         _router_case(rng, 3488, 2048, 60, 4)),
        ("serve decode T=4", _router_case(rng, 4, 2048, 60, 4)),
        ("E=128 k=8 d=1024", _router_case(rng, 2048, 1024, 128, 8)),
        ("ragged T=3489 d=2064 E=61 k=3",
         _router_case(rng, 3489, 2064, 61, 3)),
        ("all-zero rows (ties)", _router_case(rng, 700, 2048, 60, 4,
                                              zero_rows=True)),
        ("depth split T=250 d=2064 E=61 k=3",
         _router_case(rng, 250, 2064, 61, 3)),
    ]
    seen = set()
    for label, tol, (args, kw) in flash:
        picked = fa.variant(args[0].dtype, args[0].shape[-1])
        want = fa.flash_attention_plain(*args, **kw)
        for name in dict.fromkeys((picked, "simt")):
            run = (fa.flash_attention if name == picked else
                   lambda *a, _n=name, **k: fa.flash_attention_variant(
                       _n, *a, **k))
            got = run(*args, **kw)
            again = run(*args, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"flash_attention [{label}, {name}]: "
                                     f"relaunch differs")
            err = within(tol)(got.float().cpu().numpy(),
                              want.float().cpu().numpy())
            seen.add(name)
            log(f"[kernels] flash_attention {label:40s} {name:5s}"
                f"{' (picked)' if name == picked else '         '} ok  "
                f"max_abs_err={err:.6g} (tol {tol:g})  bit-identical "
                f"relaunch")
    if seen != set(fa.VARIANT_LAUNCHES):
        raise AssertionError(f"flash variants checked {seen}, have "
                             f"{set(fa.VARIANT_LAUNCHES)}")
    seen = set()
    for label, (args, kw) in topk:
        picked = tg.path(args[0].shape[1])
        widx, wgates = tg.topk_gating_plain(*args)
        got = {}
        for p in dict.fromkeys((picked, "wide")):
            got[p] = tg.topk_gating_path(p, *args)
            again = tg.topk_gating_path(p, *args)
            torch.cuda.synchronize()
            if not all(same_bits(a, b) for a, b in zip(got[p], again)):
                raise AssertionError(f"topk_gating [{label}, {p}]: relaunch "
                                     f"differs")
            idx, gates = got[p]
            exact(idx.cpu().numpy(), widx.cpu().numpy())
            err = within(1e-6)(gates.cpu().numpy(), wgates.cpu().numpy())
            seen.add(p)
            log(f"[kernels] topk_gating {label:24s} {p:6s}"
                f"{' (picked)' if p == picked else '         '} ok  indices "
                f"exact, gates max_abs_err={err:.6g}  bit-identical relaunch")
        if not all(same_bits(a, b) for a, b in zip(got[picked],
                                                   got["wide"])):
            raise AssertionError(f"topk_gating [{label}]: the {picked} "
                                 f"path's bits differ from the wide path's")
    if seen != set(tg.PATH_LAUNCHES):
        raise AssertionError(f"topk_gating paths checked {seen}")
    _topk_nan_row(tg)
    for label, args in router:
        check_router(label, *args)


def _topk_nan_row(tg) -> None:
    """A row holding NaN has no defined top k (the ops never feed one): log
    what each path and the plain version give, and check nothing."""
    x = torch.tensor([[0.5, float("nan"), 2.0, -1.0, 2.0, 0.25]] * 3,
                     device="cuda")
    x[1, 0] = float("nan")
    for p in ("narrow", "wide"):
        idx, gates = tg.topk_gating_path(p, x, 3)
        log(f"[kernels] topk_gating NaN rows {p:6s} idx {idx.tolist()} "
            f"gates {gates.tolist()} (not checked)")
    idx, gates = tg.topk_gating_plain(x, 3)
    log(f"[kernels] topk_gating NaN rows plain  idx {idx.tolist()} gates "
        f"{gates.tolist()} (not checked)")


# ---------------------------------------------------------------------------
# phases 4-5: the ops on the card against the CPU path
# ---------------------------------------------------------------------------

OPS = [
    ("flat_profile", {"metrics": ("time.exc", "time.inc")}),
    ("flat_profile", {"per_process": True}),
    ("time_profile", {"num_bins": 32}),
    ("load_imbalance", {}),
    ("comm_matrix", {}),
    ("message_histogram", {"bins": 10}),
    # -1 reports every rank (a severity of -1 or more is a work of 0 or
    # more), so the checks see every rank's busy sum
    ("stragglers", {"threshold": -1.0}),
]


def _canonical(frame):
    """Rows in key order (Name, then Process): sums that tie to within f32
    rounding may sort either way in the op's own metric order."""
    keys = [c for c in ("Process", "Name") if c in frame.columns]
    cols = [np.asarray(frame.column(c).codes if c == "Name"
                       else frame[c]) for c in keys]
    return frame.take(np.lexsort(cols)) if cols else frame


def same_findings(a, b) -> float:
    """Two Findings frames by rank: the same rows, windows exact and
    severities within the gate (explanations quote the f32 sums rounded to
    the microsecond, so they are not compared)."""
    ka, kb = (np.argsort(np.asarray(f["process"]), kind="stable")
              for f in (a, b))
    for c in ("detector", "location", "process", "function", "t_start",
              "t_end"):
        if not np.array_equal(np.asarray(a[c])[ka], np.asarray(b[c])[kb]):
            raise AssertionError(f"stragglers: column {c} differs")
    return gate(np.asarray(a["severity"])[ka], np.asarray(b["severity"])[kb])


def same_result(op, a, b) -> float:
    """The port's op on the card vs on the CPU: sums within the gate,
    counts, edges, names and histogram counts exact."""
    if op == "comm_matrix":
        return gate(a, b)
    if op == "message_histogram":
        exact(a[1], b[1])
        return exact(a[0], b[0])
    if op == "stragglers":
        return same_findings(a, b)
    if sorted(a.columns) != sorted(b.columns) or len(a) != len(b):
        raise AssertionError(f"{op}: columns / rows differ: {a.columns} "
                             f"{len(a)} vs {b.columns} {len(b)}")
    a, b = _canonical(a), _canonical(b)
    floats = [c for c in b.columns if np.asarray(b[c]).dtype.kind == "f"]
    scale = max([1.0] + [float(np.abs(np.asarray(b[c])).max())
                         for c in floats if len(b)])
    err = 0.0
    for c in b.columns:
        va, vb = np.asarray(a[c]), np.asarray(b[c])
        if c in floats:
            if not np.allclose(va, vb, rtol=1e-4, atol=1e-6 * scale):
                raise AssertionError(f"{op}: column {c} outside the gate")
            err = max(err, float(np.abs(va - vb).max()) if len(va) else 0.0)
        elif va.dtype == object:
            if not all(list(x) == list(y) for x, y in zip(va, vb)):
                raise AssertionError(f"{op}: column {c} differs")
        elif not np.array_equal(va, vb):
            raise AssertionError(f"{op}: column {c} differs")
    return err


class DeviceTimer:
    """Wraps each given kernel module's wrapper for one path's run: CUDA
    events around every call (device time of the kernel calls, sorts
    included); the first call's inputs (``inputs``) and those of the
    first call of each shape (:meth:`calls`) kept for the timing phases;
    and the host clock around the host's canonical record sort."""

    def __init__(self, mods):
        from repro_torch.core import accel
        self.mods = mods
        self.accel = accel
        self.events, self.inputs, self._orig = [], {}, {}
        self.shapes = {}
        self.sort_s = 0.0

    def __enter__(self):
        sort = self._sort = self.accel.canonical_order

        def timed_sort(*args):
            t0 = time.perf_counter()
            out = sort(*args)
            self.sort_s += time.perf_counter() - t0
            return out

        self.accel.canonical_order = timed_sort
        for mod in self.mods:
            name = mod.__name__.rsplit(".", 1)[1]
            fn = getattr(mod, name)
            self._orig[mod] = (name, fn)

            def wrapped(*args, _fn=fn, _name=name, **kw):
                if not args[0].is_cuda:        # the CPU path's plain run
                    return _fn(*args, **kw)
                self.inputs.setdefault(_name, (args, kw))
                sig = (_name,) + tuple(
                    tuple(a.shape) if isinstance(a, torch.Tensor) else a
                    for a in args) + tuple(sorted(kw.items()))
                self.shapes.setdefault(sig, (args, kw))
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                out = _fn(*args, **kw)
                t1.record()
                self.events.append((_name, t0, t1))
                return out

            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        self.accel.canonical_order = self._sort
        for mod, (name, fn) in self._orig.items():
            setattr(mod, name, fn)

    def take_seconds(self):
        """(device seconds in kernel calls, host seconds in the canonical
        sort) since the last call."""
        torch.cuda.synchronize()
        s = sum(a.elapsed_time(b) for _n, a, b in self.events) / 1e3
        out = (s, self.sort_s)
        self.events, self.sort_s = [], 0.0
        return out

    def calls(self) -> dict:
        """{kernel: [(args, kw) of each call of another shape, in call
        order]}."""
        out = {}
        for sig, inputs in self.shapes.items():
            out.setdefault(sig[0], []).append(inputs)
        return out

    def seconds_by_kernel(self) -> dict:
        """Device seconds in each kernel's wrapper calls so far."""
        torch.cuda.synchronize()
        out = {}
        for name, a, b in self.events:
            out[name] = out.get(name, 0.0) + a.elapsed_time(b) / 1e3
        return out


def run_ops(trace, label: str, timer=None) -> None:
    for op, kw in OPS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        on_card = trace.run(op, device="cuda", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        kern, sort = (timer.take_seconds() if timer is not None
                      else (float("nan"), float("nan")))
        t0 = time.perf_counter()
        on_cpu = trace.run(op, device="cpu", **kw)
        cpu_wall = time.perf_counter() - t0
        if timer is not None:
            timer.take_seconds()       # drop what the CPU path's run added
        err = same_result(op, on_card, on_cpu)
        log(f"[{label}] {op:17s} {json.dumps(kw, default=str):40s} "
            f"card wall {wall:.4f} s = kernels {kern:.4f} s + host "
            f"{wall - kern:.4f} s (canonical sort {sort:.4f} s) | cpu path "
            f"{cpu_wall:.3f} s | max_abs_err {err:.6g}")


def phase_reader() -> None:
    from repro_torch import Trace
    from repro_torch.tracegen import big_trace
    out = os.path.join(ROOT, "build", "repro_torch", "smoke_trace")
    paths = big_trace(out, nprocs=4, events_per_proc=20_000, seed=1)
    t = Trace.open(paths, device="cuda")
    log(f"[reader] {len(t)} events from {len(paths)} jsonl shards")
    run_ops(t, "reader")


def reset_counts() -> None:
    """Every trace kernel's launch count, and its count by path, to 0."""
    from repro_torch import kernels
    for mod in kernels.TRACE_KERNELS:
        mod.LAUNCHES = 0
    for name in MAIN_PATHS:
        counts = getattr(kernels, name).PATH_LAUNCHES
        counts.update(dict.fromkeys(counts, 0))


def check_counts(label: str) -> dict:
    """The trace kernels' launch counts since :func:`reset_counts`: each
    kernel must have launched, and every call on its path
    (:data:`MAIN_PATHS`)."""
    from repro_torch import kernels
    launches = {mod.__name__.rsplit(".", 1)[1]: mod.LAUNCHES
                for mod in kernels.TRACE_KERNELS}
    paths = {name: dict(getattr(kernels, name).PATH_LAUNCHES)
             for name in MAIN_PATHS}
    log(f"[{label}] launches {json.dumps(launches)}; by path "
        f"{json.dumps(paths)}")
    idle = [k for k, v in launches.items() if v <= 0]
    if idle:
        raise AssertionError(f"kernels never launched on the {label} "
                             f"path: {idle}")
    off = [k for k, p in MAIN_PATHS.items() if paths[k][p] != launches[k]]
    if off:
        raise AssertionError(f"{label}-path calls off their path "
                             f"{MAIN_PATHS}: {off}")
    return launches


def phase_main():
    from repro_torch import Trace, kernels
    from repro_torch.tracegen import big_events
    t0 = time.perf_counter()
    ev = big_events(**MAIN)
    gen_s = time.perf_counter() - t0
    trace = Trace.from_events(ev, device="cuda")
    t0 = time.perf_counter()
    trace._ensure_structure()
    trace._ensure_messages()
    struct_s = time.perf_counter() - t0
    log(f"[main] {len(ev)} events, {trace.num_processes} ranks; "
        f"generate {gen_s:.2f} s, structure {struct_s:.2f} s (host)")
    reset_counts()
    with DeviceTimer(kernels.TRACE_KERNELS) as timer:
        run_ops(trace, "main", timer)
    return trace, check_counts("main"), timer.calls()


# ---------------------------------------------------------------------------
# phases 6-7: the lazy query and streaming routes
# ---------------------------------------------------------------------------

#: the query phase's plan: the one name of main-10M that
#: ``detectors.is_comm_name`` calls communication, then half the ranks
QUERY_DROP, QUERY_RANKS = "MpiSend", range(32)
#: a second selection that keeps the sends: the halo-exchange calls go,
#: their message instants stay, so the plan recomputes structure
HALO_DROP = "halo_exchange()"
#: the stream phase's trace: the port's ``big_trace`` jsonl shards
STREAM = dict(nprocs=64, events_per_proc=15_625, calls_per_iter=500,
              seed=0)
STREAM_CHUNK_ROWS = 65_536
#: a chunk size under one shard (about 15,600 rows), so that chunk
#: boundaries split enter/leave pairs and parent chains
SEAM_CHUNK_ROWS = 4_999


def _route(ops, run) -> list:
    """Each op through ``run(op, kw)`` on the card: [(result, wall s)]."""
    out = []
    for op, kw in ops:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(op, kw)
        torch.cuda.synchronize()
        out.append((res, time.perf_counter() - t0))
    return out


def phase_query(trace) -> dict:
    """Plans over main-10M's in-memory trace on the card: each result the
    bits of the same selection made eagerly and reduced on the card."""
    from repro_torch.core import NAME, Filter
    from repro_torch.launch.cardcheck import digest

    def plan(q):
        return q.filter(Filter(NAME, "not-in", [QUERY_DROP])) \
            .restrict_processes(QUERY_RANKS)

    def halo(q):
        return q.filter(Filter(NAME, "not-in", [HALO_DROP]))

    halo_ops = [(op, kw) for op, kw in OPS
                if op in ("comm_matrix", "message_histogram")]
    reset_counts()
    lazy = [(plan, OPS, _route(
        OPS, lambda op, kw: plan(trace.query()).run(op, **kw)))]
    lazy.append((halo, halo_ops, _route(
        halo_ops, lambda op, kw: halo(trace.query()).run(op, **kw))))
    launches = check_counts("query")
    for sel, ops, results in lazy:
        t0 = time.perf_counter()
        sub = sel(trace.query()).collect()
        collect_s = time.perf_counter() - t0
        if sub.device != trace.device:
            raise AssertionError(f"selection moved to {sub.device}")
        log(f"[query] eager selection {len(sub)} of {len(trace)} events "
            f"in {collect_s:.2f} s, structure "
            f"{'remapped' if sub._structured else 'dropped (recompute)'}")
        for (op, kw), (res, wall) in zip(ops, results):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = sub.run(op, **kw)
            torch.cuda.synchronize()
            eager_s = time.perf_counter() - t0
            same = digest(res) == digest(want)
            log(f"[query] {op:17s} {json.dumps(kw, default=str):34s} "
                f"plan {wall:.3f} s | eager {eager_s:.3f} s (+ selection) "
                f"| bits {'equal' if same else 'DIFFER'}")
            if not same:
                raise AssertionError(f"query {op}: the plan's result is "
                                     f"not the eager selection's bits")
    # the card against the CPU path: stragglers over the whole trace, and
    # the first plan
    for label, op, run in (
            ("whole trace", "stragglers", lambda d: trace.run(
                "stragglers", threshold=-1.0, device=d)),
            ("plan", OPS[0][0], lambda d: plan(trace.query()).run(
                OPS[0][0], device=d, **OPS[0][1]))):
        t0 = time.perf_counter()
        on_card = run("cuda")
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        on_cpu = run("cpu")
        cpu_s = time.perf_counter() - t0
        err = same_result(op, on_card, on_cpu)
        log(f"[query] {op} on the {label}: card {card_s:.3f} s, cpu path "
            f"{cpu_s:.3f} s, max_abs_err {err:.6g}")
    return launches


def phase_stream() -> dict:
    """``Trace.open(..., streaming=True)`` over jsonl shards on the card:
    each op the bits of ``Trace.open(paths)`` on the card, and within the
    gate of the CPU streaming route."""
    import tempfile

    from repro_torch import Trace
    from repro_torch.launch.cardcheck import digest
    from repro_torch.tracegen import big_trace
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        paths = big_trace(d, **STREAM)
        write_s = time.perf_counter() - t0
        st = Trace.open(paths, streaming=True, chunk_rows=STREAM_CHUNK_ROWS,
                        device="cuda")
        reset_counts()
        streamed = _route(OPS, lambda op, kw: st.run(op, **kw))
        launches = check_counts("stream")
        t0 = time.perf_counter()
        eager = Trace.open(paths, device="cuda")
        eager._ensure_structure()
        eager._ensure_messages()
        open_s = time.perf_counter() - t0
        log(f"[stream] {len(eager)} events in {len(paths)} jsonl shards: "
            f"written in {write_s:.2f} s; eager open + structure "
            f"{open_s:.2f} s; chunks of {STREAM_CHUNK_ROWS} rows")
        for (op, kw), (res, wall) in zip(OPS, streamed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = eager.run(op, **kw)
            torch.cuda.synchronize()
            eager_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            on_cpu = st.run(op, device="cpu", **kw)
            cpu_s = time.perf_counter() - t0
            same = digest(res) == digest(want)
            err = same_result(op, res, on_cpu)
            log(f"[stream] {op:17s} {json.dumps(kw, default=str):34s} "
                f"streaming {wall:.3f} s | eager {eager_s:.3f} s | bits "
                f"{'equal' if same else 'DIFFER'} | cpu streaming "
                f"{cpu_s:.3f} s, max_abs_err {err:.6g}")
            if not same:
                raise AssertionError(f"stream {op}: not the eager bits")
        seams = Trace.open(paths, streaming=True, chunk_rows=SEAM_CHUNK_ROWS,
                           device="cuda")
        for op, kw in OPS[:3]:
            t0 = time.perf_counter()
            same = digest(seams.run(op, **kw)) == digest(eager.run(op, **kw))
            log(f"[stream] {op:17s} {json.dumps(kw, default=str):34s} "
                f"chunks of {SEAM_CHUNK_ROWS} rows "
                f"{time.perf_counter() - t0:.3f} s | bits "
                f"{'equal' if same else 'DIFFER'}")
            if not same:
                raise AssertionError(f"stream {op} at {SEAM_CHUNK_ROWS} "
                                     f"rows a chunk: not the eager bits")
    return launches


# ---------------------------------------------------------------------------
# phase 6: timing on the main path's inputs
# ---------------------------------------------------------------------------

def _bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_timing(launches, calls, routes) -> list:
    """One row per trace kernel, timed on the inputs of its first call on
    the main path; a kernel whose later main-path calls had other shapes
    also times each of those (``other_calls``)."""
    from repro_torch import kernels
    src = "src/repro_torch/csrc/{}.cu"
    replaces = {"seg_sum": "src/repro/kernels/seg_sum.py:60",
                "pair_sum": "src/repro/kernels/pair_sum.py:64",
                "time_bin": "src/repro/kernels/time_bin.py:74",
                "hist_bin": "src/repro/kernels/hist_bin.py:59"}
    rows = []
    for mod in kernels.TRACE_KERNELS:
        name = mod.__name__.rsplit(".", 1)[1]
        (args, kw), *others = calls[name]
        row = {"name": name, "route": "cuda", "source": src.format(name),
               "replaces": replaces[name], "launches": launches[name],
               "route_launches": {r: c[name] for r, c in routes.items()}}
        row.update(_time_trace_call(mod, name, args, kw))
        if row["path"] is not None:
            check = exact if name == "hist_bin" else gate
            row.update(_path_prev(mod, name, args, kw, row["path"], check))
        if others:
            row["other_calls"] = [_time_trace_call(mod, name, a, k)
                                  for a, k in others]
        rows.append(row)
    return rows


def _time_trace_call(mod, name, args, kw) -> dict:
    """A trace kernel on one call's inputs: checked against its plain
    version, timed beside it and one library call, with its bound."""
    kern = getattr(mod, name)
    plain = getattr(mod, name + "_plain")
    got, want = kern(*args, **kw), plain(*args, **kw)
    torch.cuda.synchronize()
    if name == "hist_bin":
        err = exact(got.cpu().numpy(), want.cpu().numpy())
    else:
        err = gate(got.cpu().numpy(), want.cpu().numpy())
    if name == "seg_sum":
        code, vals, n_seg = args
        n, k = vals.shape
        bytes_moved = n * 4 + n * k * 4 + n_seg * k * 4
        ops = n * k
        idx, acc = code.long(), torch.zeros((n_seg, k), device="cuda")
        library = lambda: acc.index_add_(0, idx, vals)  # noqa: E731
        call = "index_add_"
        path = mod.path(n, n_seg * k)
        keys = code if path == "sorted" else None
        shape = f"N={n} K={k} n_seg={n_seg}"
    elif name == "pair_sum":
        a, b, w, n_a, n_b = args
        n = a.shape[0]
        bytes_moved = n * 12 + n_a * n_b * 4
        ops = n
        flat = a.long() * n_b + b.long()
        acc = torch.zeros(n_a * n_b, device="cuda")
        library = lambda: acc.index_add_(0, flat, w)  # noqa: E731
        call = "index_add_ on flat cell keys"
        path = mod.path(n, n_a * n_b)
        keys = flat.int() if path == "sorted" else None
        shape = f"N={n} {n_a}x{n_b}"
    elif name == "time_bin":
        s, e, f, r = args[:4]
        n_funcs, n_bins = kw["n_funcs"], kw["n_bins"]
        t0, t1 = kw["t0"], kw["t1"]
        n = s.shape[0]
        bytes_moved = n * 16 + n_funcs * n_bins * 4
        # the (record, bin) terms this run's data needs: the bins its
        # span touches, each min, max, sub, clamp, mul, add
        bw = (t1 - t0) / n_bins
        keep = (f >= 0) & (f < n_funcs) & (e > s)
        first = torch.floor((s[keep] - t0) / bw).clamp(0, n_bins)
        end = torch.ceil((e[keep] - t0) / bw).clamp(0, n_bins)
        ops = 6 * float((end - first).clamp_min(0).double().sum())
        library = _time_library(s, e, f, r, n_funcs, n_bins, t0, t1)
        call = ("chain: torch.minimum / torch.maximum / clamp_min / "
                "mul on [N, n_bins], then index_add_")
        path = mod.path(n, n_funcs * n_bins)
        keys = f if path == "sorted" else None
        shape = f"N={n} n_funcs={n_funcs} n_bins={n_bins}"
    else:
        coords, n_bins = args
        n = coords.shape[0]
        bytes_moved = n * 4 + n_bins * 8
        ops = n
        idx = torch.floor(coords).long()
        library = lambda: torch.bincount(idx, minlength=n_bins)  # noqa
        call = "bincount"
        path = mod.path(n_bins)
        keys = None
        shape = f"N={n} n_bins={n_bins}"
    ms = cuda_ms(lambda: kern(*args, **kw), iters=20)
    dev_ms, by_kernel = device_ms(lambda: kern(*args, **kw))
    names = sorted(by_kernel)
    plain_ms = cuda_ms(lambda: plain(*args, **kw), iters=5, warm=1)
    library_ms = cuda_ms(library, iters=20)
    # the wrapper's device sort of the record keys, part of ``ms``
    sort_ms = (cuda_ms(lambda: torch.sort(keys, stable=True), iters=20)
               if keys is not None else 0.0)
    bound_ms, bound_by = _bound(bytes_moved, ops)
    log(f"[timing] {name:8s} {shape:32s} kernel {ms:.4f} ms (device "
        f"{dev_ms:.4f} ms) | plain {plain_ms:.4f} ms | library "
        f"{library_ms:.4f} ms | bound {bound_ms:.4f} ms ({bound_by}) | of "
        f"which device sort {sort_ms:.4f} ms | device kernels {names}")
    if path == "private":
        sorts = [k for k in names if "sort" in k.lower()]
        if sorts:
            raise AssertionError(f"{name}: a sort kernel on the private "
                                 f"path: {sorts}")
    if path == "narrow" and len(names) != 1:
        raise AssertionError(f"{name}: the narrow path is one device "
                             f"kernel a call, the profiler saw {names}")
    return {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "library_call": call,
            "sort_ms": sort_ms, "device_kernels": names, "shape": shape,
            "path": path, "checked": True}


def _time_library(s, e, f, r, n_funcs, n_bins, t0, t1):
    """time_bin as a chain of PyTorch calls: the dense [N, n_bins] overlap
    by broadcasting, then ``index_add_`` by func (the records' filter and
    the bin edges made outside the timed call)."""
    keep = (f >= 0) & (f < n_funcs)
    s, e, r, idx = s[keep], e[keep], r[keep], f[keep].long()
    bw = (t1 - t0) / n_bins
    lo = t0 + bw * torch.arange(n_bins, dtype=torch.float32, device="cuda")
    hi = lo + bw
    acc = torch.zeros((n_funcs, n_bins), device="cuda")

    def library():
        ov = (torch.minimum(e[:, None], hi) - torch.maximum(s[:, None], lo)
              ).clamp_min_(0.0).mul_(r[:, None])
        return acc.index_add_(0, idx, ov)
    return library


def _path_prev(mod, name, args, kw, path, check) -> dict:
    """The path that ``path`` replaced on the main path (:data:`PREV_PATH`)
    on the same inputs, held to the plain version by ``check``."""
    if path not in PREV_PATH:
        return {}
    prev_path = PREV_PATH[path]
    run = getattr(mod, name + "_path")
    prev = lambda: run(prev_path, *args, **kw)  # noqa: E731
    err = check(prev().cpu().numpy(),
                getattr(mod, name + "_plain")(*args, **kw).cpu().numpy())
    out = {"prev_path": prev_path, "prev_ms": cuda_ms(prev, iters=20),
           "prev_device_ms": device_ms(prev)[0], "prev_max_abs_err": err}
    log(f"[timing] {name} the {prev_path} path on the same inputs "
        f"{out['prev_ms']:.4f} ms (device {out['prev_device_ms']:.4f} "
        f"ms, max_abs_err {err:.6g})")
    return out


# ---------------------------------------------------------------------------
# phases 7-9: the serving path
# ---------------------------------------------------------------------------

def phase_serve():
    from repro_torch import kernels
    from repro_torch.core.constants import INC
    from repro_torch.launch import serve as launch
    checks = []

    def hook(phase, logits):
        checks.append(torch.isfinite(logits).all())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa, rt = kernels.flash_attention, kernels.router_topk
    for mod in kernels.MODEL_KERNELS:
        mod.LAUNCHES = 0
    fa.VARIANT_LAUNCHES.update(dict.fromkeys(fa.VARIANT_LAUNCHES, 0))
    rt.VARIANT_CALLS.update(dict.fromkeys(rt.VARIANT_CALLS, 0))
    with DeviceTimer(kernels.MODEL_KERNELS) as timer:
        run = launch.serve(**SERVE, device="cuda", logits_hook=hook)
    launches = {mod.__name__.rsplit(".", 1)[1]: mod.LAUNCHES
                for mod in kernels.MODEL_KERNELS}
    by_variant = dict(fa.VARIANT_LAUNCHES)
    router_calls = dict(rt.VARIANT_CALLS)
    kernel_s = timer.seconds_by_kernel()
    peak = torch.cuda.max_memory_allocated()
    cfg = run.engine.cfg
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_experts} experts top-{cfg.topk} + "
        f"{cfg.n_shared_experts} shared, {cfg.param_count() / 1e9:.2f} B "
        f"parameters in {SERVE['dtype']}")
    log(f"[serve] launches {json.dumps(launches)}; flash_attention by "
        f"variant {json.dumps(by_variant)}; router calls by route "
        f"{json.dumps(router_calls)}")
    idle = [k for k in ("flash_attention", "router_topk")
            if launches[k] <= 0]
    if idle:
        raise AssertionError(f"kernels never launched on the serving "
                             f"path: {idle}")
    if by_variant["wgmma"] != launches["flash_attention"]:
        raise AssertionError(f"prefill attention not all on the "
                             f"tensor-core kernel: {by_variant}")
    waves = -(-SERVE["requests"] // SERVE["batch"])
    calls = cfg.n_layers * waves * SERVE["new_tokens"]
    if router_calls != {"fused": calls, "unfused": 0} or \
            launches["router_topk"] != calls or launches["topk_gating"]:
        raise AssertionError(f"bf16 router calls not all on router_topk: "
                             f"{router_calls}, launches {launches}, "
                             f"expected {calls} fused")
    if len(run.done) != SERVE["requests"] or any(
            len(r.out_tokens) != SERVE["new_tokens"] for r in run.done):
        raise AssertionError("not every request got its tokens")
    bad = [t for r in run.done for t in r.out_tokens
           if not 0 <= t < cfg.vocab]
    if bad:
        raise AssertionError(f"tokens outside [0, {cfg.vocab}): {bad[:5]}")
    if not checks or not all(bool(c) for c in checks):
        raise AssertionError("non-finite logits on the serving path")
    lens = [len(r.prompt) for r in run.done]
    trace = run.tracer.to_trace(device="cuda")
    fp = trace.flat_profile(metrics=(INC,))
    prof = {n: (int(c), float(t)) for n, c, t in
            zip(fp["Name"], fp["count"], fp[INC])}
    need = {"wave", "prefill", "decode", "decode_step"}
    if not need <= set(prof):
        raise AssertionError(f"trace lacks spans {need - set(prof)}")
    if prof["prefill"][0] != waves or \
            prof["decode_step"][0] != waves * (SERVE["new_tokens"] - 1):
        raise AssertionError(f"span counts {prof}")
    prefill_s = prof["prefill"][1] / 1e9 / prof["prefill"][0]
    step_ms = prof["decode_step"][1] / 1e6 / prof["decode_step"][0]
    log(f"[serve] {len(run.done)} requests in {waves} waves, prompt "
        f"lengths {lens}; {run.summary['generated_tokens']} tokens in "
        f"{run.summary['wall_s']} s = {run.summary['tok_per_s']} tok/s")
    log(f"[serve] prefill {prefill_s:.4f} s per wave; decode "
        f"{step_ms:.3f} ms per step; peak device memory "
        f"{peak / 2**30:.2f} GiB")
    log("[serve] device time in kernel wrappers: " + ", ".join(
        f"{k} {v:.4f} s" for k, v in sorted(kernel_s.items())))
    log("[serve] trace spans (count, inclusive s): " + ", ".join(
        f"{n} ({c}, {t / 1e9:.4f})" for n, (c, t) in sorted(prof.items())))
    wave = [r.prompt for r in run.done[:SERVE["batch"]]]
    tokens = np.zeros((len(wave), max(map(len, wave))), np.int64)
    for i, p in enumerate(wave):
        tokens[i, tokens.shape[1] - len(p):] = p     # the engine's left-pad
    tokens = torch.from_numpy(tokens).to(run.engine.device)
    model, cache_len = run.engine.model, SERVE["cache_len"]
    cache, logits, pos = model.prefill(tokens, cache_len)
    cur = torch.argmax(logits[:, :cfg.vocab], dim=-1)[:, None]
    profile_step("prefill", lambda: model.prefill(tokens, cache_len))
    profile_step("decode_step", lambda: model.decode_step(cache, cur, pos,
                                                          cache_len))
    inputs = timer.inputs
    del run, trace, model, cache
    torch.cuda.empty_cache()
    return launches, inputs


def profile_step(label: str, fn, top: int = 8) -> None:
    """One call of ``fn`` under ``torch.profiler`` after a warm call: the
    device's busy share of the call's wall time (profiler on) and the
    kernels that took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    log(f"[profile] {label}: wall {wall * 1e3:.2f} ms (profiler on), "
        f"device busy {busy * 1e3:.2f} ms = {busy / wall:.1%}, "
        f"{sum(e.count for e in kern)} kernel launches")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
            f"x{e.count:<5d} {e.key[:90]}")


def phase_f32_router():
    """One ``moe_ffn`` call in float32 at the serving model's widths: the
    first wave's 3,488 prefill tokens, d_model 2048, 60 experts top-4 of
    width 1408, weights drawn on the card from seed 2 (std fan_in^-1/2, as
    the model draws them).  float32 takes the unfused route, so the
    ``topk_gating`` kernel is launched once, on its narrow path, and
    ``router_topk`` not at all: counts reset just before, read just
    after."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models.moe import moe_ffn
    cfg = get_config(ARCH)
    T, d, E, f = 3488, cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    g = torch.Generator(device="cuda").manual_seed(2)

    def draw(*shape):
        return torch.randn(shape, generator=g, device="cuda") \
            * shape[-2] ** -0.5

    x = torch.randn((T, d), generator=g, device="cuda")
    weights = (draw(d, E), draw(E, d, f), draw(E, d, f), draw(E, f, d))
    rt, tg = kernels.router_topk, kernels.topk_gating
    rt.LAUNCHES = tg.LAUNCHES = 0
    rt.VARIANT_CALLS.update(dict.fromkeys(rt.VARIANT_CALLS, 0))
    tg.PATH_LAUNCHES.update(dict.fromkeys(tg.PATH_LAUNCHES, 0))
    with DeviceTimer((tg,)) as timer:
        y = moe_ffn(x, *weights, topk=cfg.topk,
                    capacity_factor=cfg.capacity_factor,
                    groups=cfg.moe_groups)
    torch.cuda.synchronize()
    launches = {"topk_gating": tg.LAUNCHES, "router_topk": rt.LAUNCHES}
    if launches != {"topk_gating": 1, "router_topk": 0} or \
            rt.VARIANT_CALLS != {"fused": 0, "unfused": 1} or \
            tg.PATH_LAUNCHES != {"narrow": 1, "wide": 0}:
        raise AssertionError(f"f32 routing: launches {launches}, calls "
                             f"{rt.VARIANT_CALLS}, topk_gating by path "
                             f"{tg.PATH_LAUNCHES}")
    if y.shape != x.shape or not bool(torch.isfinite(y).all()):
        raise AssertionError("f32 moe_ffn: wrong shape or non-finite")
    log(f"[f32] moe_ffn float32 [{T}, {d}], {E} experts top-{cfg.topk}: "
        f"launches {json.dumps(launches)}, topk_gating by path "
        f"{json.dumps(tg.PATH_LAUNCHES)}, finite output")
    inputs = timer.inputs
    del x, weights, y
    torch.cuda.empty_cache()
    return launches, inputs


def phase_path() -> None:
    """The smoke config served on the card and on the CPU through the same
    engine code and weights: the same greedy tokens, prefill logits within
    1e-3 (f32; cuBLAS vs CPU matmuls and the kernels' summation order)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention, topk_gating
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    cfg = get_smoke_config(ARCH)
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0)).state_dict()
    out = {}
    for dev in ("cuda", "cpu"):
        logits = []
        eng = ServeEngine(cfg, batch=4, cache_len=128, params=params,
                          device=dev)
        eng.logits_hook = (lambda ph, lg, _l=logits:
                           _l.append(lg.float().cpu()) if ph == "prefill"
                           else None)
        flash_attention.LAUNCHES = topk_gating.LAUNCHES = 0
        done = eng.serve_queue(make_requests(cfg.vocab, 8, 32, 16))
        after = (flash_attention.LAUNCHES, topk_gating.LAUNCHES)
        if (dev == "cuda") != all(a > 0 for a in after):
            raise AssertionError(f"{dev}: kernel launches {after}")
        out[dev] = ([r.out_tokens for r in done], torch.cat(logits))
    (tok_card, lg_card), (tok_cpu, lg_cpu) = out["cuda"], out["cpu"]
    if tok_card != tok_cpu:
        raise AssertionError("greedy tokens differ between card and CPU")
    err = float((lg_card - lg_cpu).abs().max())
    if not err <= 1e-3:
        raise AssertionError(f"prefill logits differ by {err}")
    log(f"[path] {cfg.name} f32: {sum(map(len, tok_card))} greedy tokens "
        f"identical on the card and the CPU; prefill logits max abs err "
        f"{err:.3g} (tol 1e-3)")


def phase_model_timing(launches, inputs, f32_launches, f32_inputs) -> list:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import router_topk as rt
    from repro_torch.kernels import topk_gating as tg
    rows = []
    # flash attention on the first prefill's q, k, v
    (q, k, v), kw = inputs["flash_attention"]
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    got, again = fa.flash_attention(q, k, v, **kw), fa.flash_attention(
        q, k, v, **kw)
    want = fa.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("flash_attention: relaunch differs")
    tol = 3e-2 if q.dtype == torch.bfloat16 else 2e-5
    err = within(tol)(got.float().cpu().numpy(), want.float().cpu().numpy())
    qpos = kw.get("q_offset", 0) + torch.arange(Sq, device=q.device)
    visible = float(fa.mask(qpos, torch.arange(Sk, device=q.device),
                            kw.get("causal", True), kw.get("window"),
                            kw.get("prefix_len", 0)).sum())
    ops = 4.0 * D * visible * B * H        # QK^T and PV, 2 flops a MAC
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    peak = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else F32_OPS_PER_S
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    picked = fa.variant(q.dtype, D)
    row = _model_row(
        "flash_attention", "src/repro/kernels/flash_attention.py:101",
        launches, err, lambda: fa.flash_attention(q, k, v, **kw),
        lambda: fa.flash_attention_plain(q, k, v, **kw),
        lambda: sdpa(qt, kt, vt, is_causal=True), t_ops, t_bytes,
        f"q {list(q.shape)} k/v {list(k.shape)} {str(q.dtype)[6:]}, "
        f"{visible:.0f} visible pairs per head")
    # the SIMT kernel, which served this path before, on the same inputs
    simt = lambda: fa.flash_attention_variant("simt", q, k, v, **kw)  # noqa
    prev_err = within(tol)(simt().float().cpu().numpy(),
                           want.float().cpu().numpy())
    row.update(variant=picked, prev_variant="simt",
               prev_ms=cuda_ms(simt, iters=20),
               prev_device_ms=device_ms(simt)[0], prev_max_abs_err=prev_err)
    log(f"[timing] flash_attention variant {picked}; the SIMT kernel on "
        f"the same inputs {row['prev_ms']:.4f} ms (device "
        f"{row['prev_device_ms']:.4f} ms, max_abs_err {prev_err:.6g})")
    rows.append(row)
    rows.append(_router_row(rt, tg, launches, *inputs["router_topk"][0]))
    # top-k gating on the f32 router's logits
    (logits, k_), _kw = f32_inputs["topk_gating"]
    T, E = logits.shape
    idx, gates = tg.topk_gating(logits, k_)
    widx, wgates = tg.topk_gating_plain(logits, k_)
    torch.cuda.synchronize()
    exact(idx.cpu().numpy(), widx.cpu().numpy())
    err = within(1e-6)(gates.cpu().numpy(), wgates.cpu().numpy())
    nbytes = T * E * 4 + T * k_ * 8
    ops = T * E * k_                      # one compare per logit per round

    def library():
        vals, ids = torch.topk(logits, k_, dim=1)
        return ids, torch.softmax(vals, dim=1)

    row = _model_row(
        "topk_gating", "src/repro/kernels/topk_gating.py:50", f32_launches,
        err, lambda: tg.topk_gating(logits, k_),
        lambda: tg.topk_gating_plain(logits, k_), library,
        ops / F32_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3,
        f"T={T} E={E} k={k_}")
    # the wide path, which served this call before, on the same logits
    path = tg.path(E)
    wide = lambda: tg.topk_gating_path("wide", logits, k_)  # noqa: E731
    if not all(same_bits(a, b) for a, b in zip(wide(), (idx, gates))):
        raise AssertionError("topk_gating: the wide path's bits differ on "
                             "the f32 router's logits")
    if path != "narrow" or len(row["device_kernels"]) != 1:
        raise AssertionError(f"topk_gating: path {path}, device kernels "
                             f"{row['device_kernels']}")
    row.update(path=path, prev_path="wide", prev_ms=cuda_ms(wide, iters=20),
               prev_device_ms=device_ms(wide)[0], prev_bits_equal=True)
    log(f"[timing] topk_gating path {path}; the wide path on the same "
        f"logits {row['prev_ms']:.4f} ms (device {row['prev_device_ms']:.4f} "
        f"ms), the same bits")
    rows.append(row)
    return rows


def _router_row(rt, tg, launches, x, w, k) -> dict:
    """The fused router on the serving path's first router call (the
    first wave's prefill) and on its first 4 rows (a decode step's shape),
    beside the unfused route it replaced there (the f32 product, then the
    topk_gating kernel) and the library chain (f32 product, torch.topk,
    softmax)."""
    err = check_router("serving path's first call", x, w, k)

    def unfused(x=x):
        return tg.topk_gating(x.float() @ w.float(), k)

    def library(x=x):
        vals, ids = torch.topk(x.float() @ w.float(), k, dim=1)
        return ids, torch.softmax(vals, dim=1)

    def bound(T):
        d, E = w.shape
        nbytes = T * d * 2 + d * E * 2 + T * E * 4 + T * k * 8
        return 2.0 * T * d * E / BF16_OPS_PER_S * 1e3, \
            nbytes / HBM_BYTES_PER_S * 1e3

    T, (d, E) = x.shape[0], w.shape
    row = _model_row(
        "router_topk", "src/repro/kernels/topk_gating.py:50", launches,
        err, lambda: rt.router_topk(x, w, k),
        lambda: rt.router_topk_plain(x, w, k), library, *bound(T),
        f"x [{T}, {d}] w [{d}, {E}] bf16, k={k}")
    row.update(prev_route="f32 product + topk_gating",
               prev_ms=cuda_ms(unfused, iters=20),
               prev_device_ms=device_ms(unfused)[0])
    xd = x[:4]
    t_ops, t_bytes = bound(4)
    dec = {"decode_shape": f"x [4, {d}]",
           "decode_ms": cuda_ms(lambda: rt.router_topk(xd, w, k), iters=50),
           "decode_device_ms": device_ms(lambda: rt.router_topk(xd, w,
                                                                 k))[0],
           "decode_prev_ms": cuda_ms(lambda: unfused(xd), iters=50),
           "decode_prev_device_ms": device_ms(lambda: unfused(xd))[0],
           "decode_library_ms": cuda_ms(lambda: library(xd), iters=50),
           "decode_bound_ms": max(t_ops, t_bytes)}
    row.update(dec)
    log(f"[timing] router_topk the unfused route on the same inputs "
        f"{row['prev_ms']:.4f} ms (device {row['prev_device_ms']:.4f} ms); "
        f"decode shape: fused {dec['decode_ms']:.4f} ms (device "
        f"{dec['decode_device_ms']:.4f} ms), unfused "
        f"{dec['decode_prev_ms']:.4f} ms (device "
        f"{dec['decode_prev_device_ms']:.4f} ms), library "
        f"{dec['decode_library_ms']:.4f} ms, bound "
        f"{dec['decode_bound_ms']:.6f} ms")
    return row


def _model_row(name, replaces, launches, err, kern, plain, library, t_ops,
               t_bytes, shape) -> dict:
    ms = cuda_ms(kern, iters=20)
    dev_ms, by_kernel = device_ms(kern)
    names = sorted(by_kernel)
    plain_ms = cuda_ms(plain, iters=5, warm=1)
    library_ms = cuda_ms(library, iters=20)
    bound_ms, bound_by = ((t_bytes, "bytes") if t_bytes >= t_ops
                          else (t_ops, "operations"))
    log(f"[timing] {name:15s} {shape:60s} kernel {ms:.4f} ms (device "
        f"{dev_ms:.4f} ms) | plain {plain_ms:.4f} ms | library "
        f"{library_ms:.4f} ms | bound {bound_ms:.4f} ms ({bound_by}) | "
        f"launches {launches[name]} | device kernels {names}")
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, "shape": shape,
            "device_kernels": names, "checked": True}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    device = phase_device()
    phase_build()
    phase_kernels()
    phase_model_kernels()
    phase_reader()
    trace, launches, calls = phase_main()
    routes = {"query": phase_query(trace), "stream": phase_stream()}
    del trace
    rows = phase_timing(launches, calls, routes)
    serve_launches, serve_inputs = phase_serve()
    f32_launches, f32_inputs = phase_f32_router()
    phase_path()
    rows += phase_model_timing(serve_launches, serve_inputs, f32_launches,
                               f32_inputs)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(device["smi"])
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"],
        "count": device["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
