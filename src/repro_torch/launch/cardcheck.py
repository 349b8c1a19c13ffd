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

__all__ = ["gate", "exact", "same_bits", "digest", "set_gate",
           "findings_gate", "op_gate", "flash_bwd_tol", "flash_draw",
           "flash_gate_share",
           "topk_bwd_err", "topk_bwd_bound_ms", "HBM_BYTES_PER_S",
           "flash_forward_lse", "cuda_ms", "device_ms", "short_name",
           "card_line", "ptxas", "run_trees"]

#: profiles :func:`device_ms` takes, one after another, before it gives up
#: on one that records no device activity: in long ``chip_smoke.py`` runs
#: a profile has recorded none once and the next one all, and once three
#: in a row did
PROFILES = 6
#: q's scale in a peaked flash-attention case: scores ``D^-0.5 q.k`` of
#: standard deviation 4, so each row's softmax weighs a few keys and its
#: output is of order one
PEAKED_Q = 4.0
#: v's bound in a peaked case, drawn uniform on ``[-PEAKED_V, PEAKED_V]``:
#: every output, a convex combination of rows of v, stays inside (-4, 4),
#: where one bfloat16 step (at most 1/64) is half the 3e-2 gate
PEAKED_V = 3.5
#: the largest share of a peaked case's mean output magnitude its gate may
#: be, so that the gate is well under what it compares
PEAKED_GATE_SHARE = 0.1
#: the router backward's gate: 1e-6 x its row's largest |g_j dg_j|
TOPK_BWD_TOL = 1e-6
#: the H100 SXM's HBM3 rate (NVIDIA data sheet), bytes a second
HBM_BYTES_PER_S = 3.35e12


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
    by their ``repr``), an array, or a tuple or list of those — so two
    results have one digest only when they are the same bits."""
    h = hashlib.sha256()

    def add(x) -> None:
        if hasattr(x, "columns") and hasattr(x, "column"):
            for c in x.columns:
                h.update(repr(c).encode())
                add(np.asarray(x[c]))
        elif isinstance(x, tuple):
            for part in x:
                add(part)
        elif isinstance(x, list):  # a trace op mapped over a set
            h.update(b"list")
            for part in x:
                add(part)
        else:
            a = np.asarray(x)
            h.update(f"{a.dtype.str}{a.shape}".encode())
            h.update(repr(a.tolist()).encode() if a.dtype == object
                     else np.ascontiguousarray(a).tobytes())

    add(result)
    return h.hexdigest()


#: set-op columns whose values are exact on every device: names, runs,
#: process counts, durations and totals (host float64 of integer ns),
#: bins and statuses
SET_EXACT = ("Name", "Run", "num_processes", "duration", "speedup",
             "efficiency", "time.exc.total", "time.inc.total", "bin",
             "bin_frac", "status")


def _scale(values) -> float:
    v = np.asarray(values, np.float64)
    v = v[np.isfinite(v)]
    return float(np.abs(v).max()) if len(v) else 0.0


def set_gate(op: str, got, want, member_scale: float = None) -> float:
    """A set op's result ``got`` against ``want`` (``core/diff.py``), rows
    keyed by ``Name`` (or ``Run``, or ``bin``): the exact columns
    (:data:`SET_EXACT`) equal, a member's sums within :func:`gate`, a
    delta of two members within the gate of what it subtracts (rtol 1e-4
    plus 2 x (1e-4 + 1e-6) x ``member_scale``, the largest magnitude the
    members hold; by default that of ``want``'s member columns).  Returns
    the max abs error over the float columns; raises ``AssertionError``."""
    key = ("Name" if "Name" in want.columns else
           "Run" if "Run" in want.columns else "bin")
    kg, kw = ([str(x) for x in f[key]] for f in (got, want))
    if sorted(got.columns) != sorted(want.columns) or \
            sorted(kg) != sorted(kw):
        raise AssertionError(f"{op}: columns or rows differ")
    at = {k: i for i, k in enumerate(kg)}
    perm = np.asarray([at[k] for k in kw], np.int64)
    if member_scale is None:
        member_scale = max([0.0] + [_scale(want[c]) for c in want.columns
                                    if "|" in c
                                    and not c.startswith("delta")])
    err = 0.0
    for c in want.columns:
        a, b = np.asarray(got[c])[perm], np.asarray(want[c])
        if c in SET_EXACT or b.dtype.kind != "f":
            if not np.array_equal(a, b):
                raise AssertionError(f"{op}: column {c} differs")
            continue
        delta = c.startswith("delta") and c != "delta_rel" or \
            op == "diff_time_profile"
        atol = 1e-6 * max(_scale(b), 1.0)
        if delta:
            atol = max(atol, 2 * (1e-4 + 1e-6) * member_scale)
        if not np.allclose(a, b, rtol=1e-4, atol=atol, equal_nan=True):
            raise AssertionError(f"{op}: column {c} outside the gate")
        fin = np.isfinite(b)
        if not np.array_equal(a[~fin], b[~fin]):
            raise AssertionError(f"{op}: column {c}: non-finite differ")
        if fin.any():
            err = max(err, float(np.abs(a[fin] - b[fin]).max()))
    return err


def findings_gate(got, want) -> float:
    """Two Findings frames keyed by (detector, location): the same rows,
    every field exact but the ``stragglers`` rows' severity (within
    :func:`gate`: ``seg_sum`` sums in f32) and explanation (which quotes
    those sums).  Returns the max abs severity error; raises
    ``AssertionError``."""
    def keys(f):
        return [(str(d), str(loc)) for d, loc in zip(f["detector"],
                                                     f["location"])]

    kg, kw = keys(got), keys(want)
    if sorted(kg) != sorted(kw):
        raise AssertionError(f"findings differ: {kg} vs {kw}")
    at = {k: i for i, k in enumerate(kg)}
    perm = np.asarray([at[k] for k in kw], np.int64)
    strag = np.asarray([d == "stragglers" for d, _ in kw], bool)
    for c in ("process", "function", "t_start", "t_end"):
        if not np.array_equal(np.asarray(got[c])[perm],
                              np.asarray(want[c])):
            raise AssertionError(f"findings: column {c} differs")
    a = np.asarray(got["severity"], np.float64)[perm]
    b = np.asarray(want["severity"], np.float64)
    ea = np.asarray(got["explanation"])[perm]
    eb = np.asarray(want["explanation"])
    if not (np.array_equal(a[~strag], b[~strag])
            and list(ea[~strag]) == list(eb[~strag])):
        raise AssertionError("findings: a host detector's row differs")
    return gate(a[strag], b[strag]) if strag.any() else 0.0


def op_gate(op: str, got, want) -> float:
    """One trace op's result ``got`` against ``want`` where the two need
    not be the same bits (a ``fold="chunks"`` route against the eager one
    or the reference's): float columns and arrays within :func:`gate`,
    counts, names, bin edges, histogram counts and list cells exact, a
    Findings frame by :func:`findings_gate`.  Frame rows are keyed by
    ``Name`` and ``Process`` and columns by name, since sums that tie
    within the gate may sort either way.  Returns the max abs error;
    raises ``AssertionError`` naming the op and column."""
    if hasattr(want, "columns") and "detector" in want.columns:
        return findings_gate(got, want)
    if isinstance(want, tuple):  # (values, edges): the two histograms
        exact(got[1], want[1])
        values = np.asarray(want[0])
        if values.dtype.kind != "f":
            return exact(got[0], values)
        return gate(got[0], values)
    if not hasattr(want, "columns"):
        return gate(got, want)
    if sorted(got.columns) != sorted(want.columns) or len(got) != len(want):
        raise AssertionError(f"{op}: columns or rows differ")
    keys = [c for c in ("Name", "Process") if c in want.columns]
    if keys:
        kg, kw = ([tuple(str(x) for x in row)
                   for row in zip(*(f[c] for c in keys))]
                  for f in (got, want))
        at = {k: i for i, k in enumerate(kg)}
        if sorted(kg) != sorted(kw):
            raise AssertionError(f"{op}: rows differ")
        perm = np.asarray([at[k] for k in kw], np.int64)
    else:
        perm = np.arange(len(want))
    err = 0.0
    for c in want.columns:
        a, b = np.asarray(got[c])[perm], np.asarray(want[c])
        if b.dtype.kind == "f":
            try:
                err = max(err, gate(a, b))
            except AssertionError as e:
                raise AssertionError(f"{op}: column {c}: {e}") from None
        elif b.dtype == object:
            if not all(list(x) == list(y) for x, y in zip(a, b)):
                raise AssertionError(f"{op}: column {c} differs")
        elif not np.array_equal(a.astype(str), b.astype(str)):
            raise AssertionError(f"{op}: column {c} differs")
    return err


def flash_bwd_tol(dtype, want) -> float:
    """The gate of one flash-attention gradient (dq, dk or dv) against its
    reference ``want`` (a tensor or an array): 2e-5 in float32 and 3e-2 in
    bfloat16, times the largest magnitude of ``want``, so that the limit
    keeps its meaning on gradients of any size."""
    w = _f64(want)
    mag = float(np.abs(w).max()) if w.size else 0.0
    return (2e-5 if dtype == torch.float32 else 3e-2) * mag


def topk_bwd_err(got, want, gates, dgates) -> float:
    """The router backward ``got`` ([T, E] dlogits) against its plain
    version ``want``: the same nonzero pattern exactly, and each value
    within :data:`TOPK_BWD_TOL` x its row's largest ``|g_j dg_j|`` (the
    scale of the row's contributions, which holds its meaning whatever the
    incoming gradient's size).  Returns the max abs error; raises
    ``AssertionError`` outside the gate."""
    a, b = _f64(got), _f64(want)
    if a.shape != b.shape:
        raise AssertionError(f"shape {a.shape} != {b.shape}")
    if not np.array_equal(a != 0, b != 0):
        raise AssertionError(f"nonzero pattern differs in "
                             f"{int(((a != 0) != (b != 0)).sum())} places")
    if not a.size:
        return 0.0
    row = np.abs(_f64(gates) * _f64(dgates)).max(axis=1, keepdims=True)
    err = np.abs(a - b)
    if not bool((err <= TOPK_BWD_TOL * row).all()):
        raise AssertionError(f"outside {TOPK_BWD_TOL:g} x the row's largest "
                             f"|g dg|: max abs err {float(err.max())}")
    return float(err.max())


def topk_bwd_bound_ms(T: int, E: int, k: int, incoming: bool) -> float:
    """The least time of the router backward on the H100, in ms: bytes
    over :data:`HBM_BYTES_PER_S` (reads T k 12 bytes of idx, gates and
    their gradient, plus T E 4 of an incoming logits gradient; writes T E
    4); its few operations a byte leave it bound by bytes."""
    nbytes = T * k * 12 + T * E * 4 + (T * E * 4 if incoming else 0)
    return nbytes / HBM_BYTES_PER_S * 1e3


def flash_draw(rng, q_shape, kv_shape, peaked: bool = False):
    """q, k and v of a flash-attention case as float32 arrays from ``rng``:
    each standard normal, or with ``peaked`` q times :data:`PEAKED_Q` and
    v uniform on ``[-PEAKED_V, PEAKED_V]``, so the outputs are of order
    one and an absolute gate of 3e-2 is a small share of them."""
    q = rng.standard_normal(q_shape).astype(np.float32)
    k = rng.standard_normal(kv_shape).astype(np.float32)
    if not peaked:
        return q, k, rng.standard_normal(kv_shape).astype(np.float32)
    return (q * np.float32(PEAKED_Q), k,
            rng.uniform(-PEAKED_V, PEAKED_V, kv_shape).astype(np.float32))


def flash_gate_share(tol: float, want) -> float:
    """``tol`` as a share of the mean magnitude of the plain output
    ``want``: raises above :data:`PEAKED_GATE_SHARE`, where the gate would
    pass a kernel that lost part of each row's keys."""
    mean = float(np.abs(_f64(want)).mean())
    share = tol / mean if mean > 0 else float("inf")
    if not share <= PEAKED_GATE_SHARE:
        raise AssertionError(f"the gate {tol} is {share:.3g} of the "
                             f"output's mean magnitude {mean:.4g}")
    return share


def flash_forward_lse(q, k, v, **kw):
    """The flash forward kernel the wrapper picks, on CUDA inputs, asked
    for each row's log-sum-exp as the training forward asks: (out, lse
    f32 [B, H, Sq]), the inputs of ``flash_attention_bwd`` in a check."""
    from ..kernels import flash_attention as fa
    D = q.shape[-1]
    return fa._launch(fa.variant(q.dtype, D), q, k, v,
                      fa._config(D, **kw), want_lse=True)


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
    :data:`PROFILES` times; then it raises.  A profile that lost only part
    of its kernels' records is not detected."""
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
