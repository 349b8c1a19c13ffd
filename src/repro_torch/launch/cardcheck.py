"""Checks and timers for the port's kernels on the card.

``chip_smoke.py``, :mod:`.flash_bench`, :mod:`.trace_bench` and the
``tests/test_torch_*.py`` files take their gate, their relaunch check,
their result digest, their timers and their per-checkout runner from
here, so that each is defined once.  Importing it needs no card; the timers and :func:`card_line` do.
"""

from __future__ import annotations

import hashlib
import os
import re
import subprocess
from typing import Dict, Iterator, Sequence, Tuple

import numpy as np
import torch

__all__ = ["gate", "exact", "same_bits", "digest", "cuda_ms",
           "device_ms", "short_name", "card_line", "ptxas", "run_trees"]

#: profiles :func:`device_ms` takes before it gives up on one that records
#: no device activity (it happened once in a long ``chip_smoke.py`` run)
PROFILES = 3


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().double().numpy()
    return np.asarray(x, np.float64)


def gate(got, want) -> float:
    """``got`` against the reference ``want`` to f32 rounding: rtol 1e-4
    plus an absolute tolerance of 1e-6 x the largest finite magnitude of
    ``want`` (f32 accumulation error grows with the magnitude summed); NaN
    and infinities only where ``want`` has the same.  Tensors or arrays.
    Returns the max abs error over ``want``'s finite values; raises
    ``AssertionError`` outside the gate."""
    a, b = _f64(got), _f64(want)
    if a.shape != b.shape:
        raise AssertionError(f"shape {a.shape} != {b.shape}")
    fin = np.isfinite(b)
    scale = max(float(np.abs(b[fin]).max()) if fin.any() else 0.0, 1.0)
    err = float(np.abs(a[fin] - b[fin]).max()) if fin.any() else 0.0
    if not np.allclose(a, b, rtol=1e-4, atol=1e-6 * scale, equal_nan=True):
        raise AssertionError(f"outside the gate: max abs err {err} over "
                             f"finite values, scale {scale}")
    return err


def exact(got, want) -> float:
    """Counts (tensors or arrays) equal element for element; returns 0.0,
    the max abs error, and raises ``AssertionError`` otherwise."""
    if isinstance(got, torch.Tensor):
        got = got.cpu().numpy()
    if isinstance(want, torch.Tensor):
        want = want.cpu().numpy()
    if not np.array_equal(np.asarray(got), np.asarray(want)):
        raise AssertionError("counts differ")
    return 0.0


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-identical tensors, NaN payloads included (``torch.equal`` is
    false on NaN)."""
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def digest(result) -> str:
    """SHA-256 over every bit of an op's result — an EventFrame (column
    names in order, each column's dtype and bytes; list and string cells
    by their ``repr``), an array, or a tuple of those — so two results
    have one digest only when they are the same bits."""
    h = hashlib.sha256()

    def add(x) -> None:
        if hasattr(x, "columns") and hasattr(x, "column"):
            for c in x.columns:
                h.update(repr(c).encode())
                add(np.asarray(x[c]))
        elif isinstance(x, tuple):
            for part in x:
                add(part)
        else:
            a = np.asarray(x)
            h.update(f"{a.dtype.str}{a.shape}".encode())
            h.update(repr(a.tolist()).encode() if a.dtype == object
                     else np.ascontiguousarray(a).tobytes())

    add(result)
    return h.hexdigest()


def cuda_ms(fn, iters: int, warm: int = 2) -> float:
    """Mean ms a call of ``fn`` over ``iters`` back-to-back calls after
    ``warm`` ones: CUDA events around the calls, so host overhead counts
    where a call's kernels are shorter than its launch."""
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


def device_ms(fn, iters: int = 20) -> Tuple[float, Dict[str, float]]:
    """Device-only time of one call of ``fn``: the durations of the device
    kernels it launches, from ``torch.profiler``, averaged over ``iters``
    calls after a warm one; (total ms, {kernel name: ms}).  A profile that
    records no device activity at all is logged and taken again, up to
    :data:`PROFILES` times; then it raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        by = {}
        for e in events:
            if e.device_type == DeviceType.CUDA:
                by[e.key] = by.get(e.key, 0.0) + \
                    e.self_device_time_total / 1e3 / iters
        if sum(by.values()) > 0:
            return sum(by.values()), by
        print(f"[device_ms] profile {attempt} of {PROFILES}: the profiler "
              f"saw no device time ({len(events)} host events)", flush=True)
    raise AssertionError("the profiler saw no device time")


def short_name(kernel: str) -> str:
    """A device kernel's name from the profiler without its return type,
    namespaces, template arguments and parameters."""
    kernel = re.sub(r"^void |\(anonymous namespace\)::", "", kernel)
    return kernel.split("(")[0].split("<")[0].rsplit("::", 1)[-1]


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip()


def ptxas(build_log: str, pattern: str) -> Iterator[Tuple[re.Match, str]]:
    """For each kernel of an ``nvcc -Xptxas -v`` log whose mangled name
    matches ``pattern``: the match, and ptxas's registers and spill lines
    joined."""
    lines = build_log.splitlines()
    for i, line in enumerate(lines):
        m = re.search(pattern, line)
        if "Compiling entry" in line and m:
            yield m, " | ".join(x.strip() for x in lines[i + 1:i + 4]
                                if "spill" in x or "registers" in x)


def run_trees(trees: Sequence[str], argv: Sequence[str]) -> int:
    """Run ``argv`` once for each checkout in ``trees``, in the order
    given, from its root with its ``src`` on ``PYTHONPATH``; the exit
    codes OR-ed."""
    rc = 0
    for tree in trees:
        env = dict(os.environ, PYTHONPATH=os.path.join(
            os.path.abspath(tree), "src"))
        rc |= subprocess.run(list(argv), cwd=tree, env=env).returncode
    return rc
