"""Drive the PyTorch + CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. device  — name, count and ``nvidia-smi`` name / power limit;
2. build   — compile every ``src/repro_torch/csrc/*.cu`` for sm_90a and
             print the ptxas register / shared-memory / spill lines;
3. kernels — each kernel against its plain PyTorch version on the card at
             the main path's shapes, wider shapes and edge cases, and
             bit-identical on relaunch;
4. reader  — a small ``big_trace`` jsonl trace through ``Trace.open`` and
             the five ops on the card and on the CPU;
5. main    — 10M events over 64 ranks (``big_trace`` parameters, seed 0):
             structure, then the six op calls on the card, each held
             against the CPU path; the kernels' launch counts are reset
             just before and read just after, and each must have risen;
6. timing  — each kernel on the inputs the main path gave it: its time,
             its plain version's, one library call's, and its bound.

It prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``.  It imports nothing of the JAX
reference package.  Without a CUDA device it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
MAIN = dict(nprocs=64, events_per_proc=156_250, seed=0)


def log(*parts) -> None:
    print(*parts, flush=True)


def gate(a, b) -> float:
    """Kernel result vs reference to f32 rounding: rtol 1e-4 plus an
    absolute tolerance of 1e-6 x the largest magnitude (f32 accumulation
    error scales with the accumulated magnitude).  Returns the max abs
    error; raises when outside."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise AssertionError(f"shape {a.shape} != {b.shape}")
    if a.size == 0:
        return 0.0
    scale = max(float(np.abs(b).max()), 1.0)
    if not np.allclose(a, b, rtol=1e-4, atol=1e-6 * scale):
        bad = np.abs(a - b).max()
        raise AssertionError(f"outside the gate: max abs err {bad}, "
                             f"scale {scale}")
    return float(np.abs(a - b).max())


def exact(a, b) -> float:
    if not np.array_equal(np.asarray(a), np.asarray(b)):
        raise AssertionError("counts differ")
    return 0.0


def cuda_ms(fn, iters: int, warm: int = 2) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


# ---------------------------------------------------------------------------
# phases 1-2
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    log(f"[device] {name} x{count}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(smi.stdout.strip())
    return {"kind": name, "count": count, "smi": smi.stdout.strip()}


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


def _seg_case(rng, n, n_seg, k, pad=0.0):
    code = rng.integers(0, n_seg, size=n).astype(np.int32)
    code[rng.random(n) < pad] = -1
    vals = rng.integers(5_000, 40_000, size=(n, k)).astype(np.float32)
    return _dev(code), _dev(vals), n_seg


def _pair_case(rng, n, n_a, n_b, pad=0.0):
    a = rng.integers(0, n_a, size=n).astype(np.int32)
    b = rng.integers(0, n_b, size=n).astype(np.int32)
    a[rng.random(n) < pad] = -1
    w = rng.integers(256, 8192, size=n).astype(np.float32)
    return _dev(a), _dev(b), _dev(w), n_a, n_b


def _time_case(rng, n, n_funcs, n_bins, zero=0.0, pad=0.0):
    s = rng.random(n) * n_bins
    d = rng.exponential(2e-3, size=n)
    d[rng.random(n) < 0.001] *= 5000           # a few long calls
    d[rng.random(n) < zero] = 0.0              # zero-duration calls
    e = np.minimum(s + d, n_bins)
    f = rng.integers(0, n_funcs, size=n).astype(np.int32)
    f[rng.random(n) < pad] = -1
    r = (rng.integers(5_000, 40_000, size=n) / np.maximum(d, 1e-9)
         * (d > 0))
    return (_dev(s.astype(np.float32)), _dev(e.astype(np.float32)),
            _dev(f), _dev((r * 1e-6).astype(np.float32)), n_funcs, n_bins,
            0.0, float(n_bins))


def _hist_case(rng, n, n_bins, pad=0.0):
    x = rng.integers(0, n_bins, size=n) + 0.5
    x[rng.random(n) < pad] = -1.0
    return _dev(x.astype(np.float32)), n_bins


def phase_kernels() -> None:
    from repro_torch.kernels import hist_bin, pair_sum, seg_sum, time_bin
    rng = np.random.default_rng(0)
    cases = {
        "seg_sum": (seg_sum.seg_sum, seg_sum.seg_sum_plain, gate, [
            ("main 4.3M x2, 6 names", _seg_case(rng, 4_300_000, 6, 2)),
            ("1024 names", _seg_case(rng, 4_300_000, 1024, 1)),
            ("N=1", _seg_case(rng, 1, 5, 2)),
            ("N=1000, padded", _seg_case(rng, 1000, 7, 3, pad=0.2)),
            ("all codes < 0", _seg_case(rng, 5000, 7, 1, pad=1.0)),
            ("K=11", _seg_case(rng, 20_000, 9, 11)),
        ]),
        "pair_sum": (pair_sum.pair_sum, pair_sum.pair_sum_plain, gate, [
            ("main ranks x ranks 0.7M", _pair_case(rng, 700_000, 64, 64)),
            ("main names x ranks 4.3M", _pair_case(rng, 4_300_000, 6, 64)),
            ("1024 x 1024", _pair_case(rng, 4_300_000, 1024, 1024)),
            ("N=1", _pair_case(rng, 1, 3, 3)),
            ("N=1000, padded", _pair_case(rng, 1000, 5, 7, pad=0.2)),
            ("all codes < 0", _pair_case(rng, 5000, 5, 7, pad=1.0)),
        ]),
        "time_bin": (time_bin.time_bin, time_bin.time_bin_plain, gate, [
            ("main 4.3M, 32 bins", _time_case(rng, 4_300_000, 6, 32)),
            ("1024 bins", _time_case(rng, 500_000, 13, 1024)),
            ("N=1", _time_case(rng, 1, 3, 8)),
            ("N=1000, zero-duration", _time_case(rng, 1000, 7, 10,
                                                 zero=0.3, pad=0.1)),
            ("all funcs < 0", _time_case(rng, 5000, 7, 10, pad=1.0)),
        ]),
        "hist_bin": (hist_bin.hist_bin, hist_bin.hist_bin_plain, exact, [
            ("main 0.7M, 10 bins", _hist_case(rng, 700_000, 10)),
            ("1024 bins", _hist_case(rng, 700_000, 1024)),
            ("20000 bins", _hist_case(rng, 700_000, 20_000)),
            ("N=1", _hist_case(rng, 1, 4)),
            ("N=1000, padded", _hist_case(rng, 1000, 7, pad=0.2)),
            ("all < 0", _hist_case(rng, 5000, 7, pad=1.0)),
        ]),
    }
    for name, (kernel, plain, check, items) in cases.items():
        for label, args in items:
            got = kernel(*args)
            again = kernel(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"{name} [{label}]: relaunch differs")
            err = check(got.cpu().numpy(), want.cpu().numpy())
            log(f"[kernels] {name:8s} {label:28s} ok  max_abs_err={err:.6g}"
                f"  bit-identical relaunch")


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
]


def _canonical(frame):
    """Rows in key order (Name, then Process): sums that tie to within f32
    rounding may sort either way in the op's own metric order."""
    keys = [c for c in ("Process", "Name") if c in frame.columns]
    cols = [np.asarray(frame.column(c).codes if c == "Name"
                       else frame[c]) for c in keys]
    return frame.take(np.lexsort(cols)) if cols else frame


def same_result(op, a, b) -> float:
    """The port's op on the card vs on the CPU: sums within the gate,
    counts, edges, names and histogram counts exact."""
    if op == "comm_matrix":
        return gate(a, b)
    if op == "message_histogram":
        exact(a[1], b[1])
        return exact(a[0], b[0])
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
    """Wraps each kernel module's wrapper for one main-path run: CUDA
    events around every call (device time of the kernel calls, sorts
    included) and the first call's inputs kept for the timing phase; and
    the host clock around the host's canonical record sort."""

    def __init__(self):
        from repro_torch import kernels
        from repro_torch.core import accel
        self.mods = kernels.KERNELS
        self.accel = accel
        self.events, self.inputs, self._orig = [], {}, {}
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
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                out = _fn(*args, **kw)
                t1.record()
                self.events.append((t0, t1))
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
        s = sum(a.elapsed_time(b) for a, b in self.events) / 1e3
        out = (s, self.sort_s)
        self.events, self.sort_s = [], 0.0
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
    for mod in kernels.KERNELS:
        mod.LAUNCHES = 0
    with DeviceTimer() as timer:
        run_ops(trace, "main", timer)
    launches = {mod.__name__.rsplit(".", 1)[1]: mod.LAUNCHES
                for mod in kernels.KERNELS}
    log(f"[main] launches {json.dumps(launches)}")
    idle = [k for k, v in launches.items() if v <= 0]
    if idle:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{idle}")
    return launches, timer.inputs


# ---------------------------------------------------------------------------
# phase 6: timing on the main path's inputs
# ---------------------------------------------------------------------------

def _bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_timing(launches, inputs) -> list:
    from repro_torch import kernels
    src = "src/repro_torch/csrc/{}.cu"
    replaces = {"seg_sum": "src/repro/kernels/seg_sum.py:60",
                "pair_sum": "src/repro/kernels/pair_sum.py:64",
                "time_bin": "src/repro/kernels/time_bin.py:74",
                "hist_bin": "src/repro/kernels/hist_bin.py:59"}
    rows = []
    for mod in kernels.KERNELS:
        name = mod.__name__.rsplit(".", 1)[1]
        args, kw = inputs[name]
        kern = getattr(mod, name)
        plain = getattr(mod, name + "_plain")
        got, want = kern(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        if name == "hist_bin":
            err = exact(got.cpu().numpy(), want.cpu().numpy())
        else:
            err = gate(got.cpu().numpy(), want.cpu().numpy())
        library = None
        if name == "seg_sum":
            code, vals, n_seg = args
            n, k = vals.shape
            bytes_moved = n * 4 + n * k * 4 + n_seg * k * 4
            ops = n * k
            idx, acc = code.long(), torch.zeros((n_seg, k), device="cuda")
            library = lambda: acc.index_add_(0, idx, vals)  # noqa: E731
            keys = code
            shape = f"N={n} K={k} n_seg={n_seg}"
        elif name == "pair_sum":
            a, b, w, n_a, n_b = args
            n = a.shape[0]
            bytes_moved = n * 12 + n_a * n_b * 4
            ops = n
            flat = a.long() * n_b + b.long()
            acc = torch.zeros(n_a * n_b, device="cuda")
            library = lambda: acc.index_add_(0, flat, w)  # noqa: E731
            keys = flat.int()
            shape = f"N={n} {n_a}x{n_b}"
        elif name == "time_bin":
            s, e, f, r = args[:4]
            n_funcs, n_bins = kw["n_funcs"], kw["n_bins"]
            n = s.shape[0]
            bytes_moved = n * 16 + n_funcs * n_bins * 4
            first = torch.floor(s).clamp(0, n_bins)
            last = torch.ceil(e).clamp(0, n_bins)
            pairs = float((last - first).clamp_min(1)[f >= 0].sum())
            ops = 5 * pairs        # min, max, sub, max, mul-add per pair
            keys = f
            shape = f"N={n} n_funcs={n_funcs} n_bins={n_bins}"
        else:
            coords, n_bins = args
            n = coords.shape[0]
            bytes_moved = n * 4 + n_bins * 8
            ops = n
            idx = torch.floor(coords).long()
            library = lambda: torch.bincount(idx, minlength=n_bins)  # noqa
            keys = None
            shape = f"N={n} n_bins={n_bins}"
        ms = cuda_ms(lambda: kern(*args, **kw), iters=20)
        plain_ms = cuda_ms(lambda: plain(*args, **kw), iters=5, warm=1)
        library_ms = cuda_ms(library, iters=20) if library else None
        # the wrapper's device sort of the record keys, part of ``ms``
        sort_ms = (cuda_ms(lambda: torch.sort(keys, stable=True), iters=20)
                   if keys is not None else 0.0)
        bound_ms, bound_by = _bound(bytes_moved, ops)
        log(f"[timing] {name:8s} {shape:32s} kernel {ms:.4f} ms | plain "
            f"{plain_ms:.4f} ms | library "
            f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'} | "
            f"bound {bound_ms:.4f} ms ({bound_by}) | of which device "
            f"sort {sort_ms:.4f} ms")
        rows.append({"name": name, "route": "cuda",
                     "source": src.format(name),
                     "replaces": replaces[name],
                     "launches": launches[name], "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms,
                     "sort_ms": sort_ms, "shape": shape, "checked": True})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    device = phase_device()
    phase_build()
    phase_kernels()
    phase_reader()
    launches, inputs = phase_main()
    rows = phase_timing(launches, inputs)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(device["smi"])
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"],
        "count": device["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
