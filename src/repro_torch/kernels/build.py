"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled for Hopper (``sm_90a``) by its own
``nvcc`` process — all started together — and the objects are linked into
one shared library under ``build/repro_torch/`` at the repository root.
Each kernel's entry point has a plain C interface and is called through
``ctypes``; nothing here includes PyTorch's headers, so a build takes
seconds.  The build runs at first use, never at import, and a failed build
raises with the compiler's output.  The library's file name carries a hash
of the sources and flags, so an edited source is rebuilt.  The first call
may come from several threads at once (the trace-query service's lanes):
:func:`library` builds and loads under a lock, and each process compiles
into object files of its own.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

__all__ = ["library", "build", "check", "refuse_wrapped", "raw_stream",
           "stream_of", "BUILD_DIR", "SOURCES", "COUNT_LOCK"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("seg_sum.cu", "pair_sum.cu", "time_bin.cu", "hist_bin.cu",
           "flash_attention.cu", "flash_attention_bwd.cu", "topk_gating.cu",
           "topk_gating_bwd.cu", "router_topk.cu")
#: sorted records per CTA in the walk pass of csrc/runs.cuh (keep in step)
CHUNK = 1024
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I64, _I32, _F32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_float)
#: argtypes of every C entry point (pointers and the stream as c_void_p)
SIGNATURES = {
    # (device, skeys, perm, values, n, k, n_seg, partial, out, stream)
    "pipit_seg_sum": (_I32, _P, _P, _P, _I64, _I32, _I32, _P, _P, _P),
    # (device, code, values, n, k, n_seg, tile, partial, out, stream)
    "pipit_seg_sum_private": (_I32, _P, _P, _I64, _I32, _I32, _I32, _P, _P,
                              _P),
    # (device, a, b, n, n_a, n_b, keys, stream)
    "pipit_pair_keys": (_I32, _P, _P, _I64, _I32, _I32, _P, _P),
    # (device, skeys, perm, w, n, n_cells, partial, out, stream)
    "pipit_pair_sum": (_I32, _P, _P, _P, _I64, _I32, _P, _P, _P),
    # (device, a, b, w, n, n_a, n_b, partial, out, stream)
    "pipit_pair_sum_private": (_I32, _P, _P, _P, _I64, _I32, _I32, _P, _P,
                               _P),
    # (device, skeys, perm, start, end, rate, n, n_funcs, n_bins, t0, bw,
    #  partial, out, stream)
    "pipit_time_bin": (_I32, _P, _P, _P, _P, _P, _I64, _I32, _I32, _F32,
                       _F32, _P, _P, _P),
    # (device, start, end, func, rate, n, n_funcs, n_bins, t0, bw, tile,
    #  partial, out, stream)
    "pipit_time_bin_private": (_I32, _P, _P, _P, _P, _I64, _I32, _I32, _F32,
                               _F32, _I32, _P, _P, _P),
    # (device, coords, n, n_bins, out, stream)
    "pipit_hist_bin": (_I32, _P, _I64, _I32, _P, _P),
    # (device, coords, n, n_bins, scratch, out, stream)
    "pipit_hist_bin_narrow": (_I32, _P, _I64, _I32, _P, _P, _P),
    # (device, q, k, v, out, lse, B, Sq, Sk, H, KVH, D, dtype, variant,
    #  causal, has_window, window, prefix_len, q_offset, scale, stream)
    "pipit_flash_attention": (_I32, *(_P,) * 5, *(_I32,) * 13, _F32, _P),
    # (device, q, k, v, o, dout, lse, dq, dk, dv, delta, B, Sq, Sk, H, KVH,
    #  D, dtype, variant, causal, has_window, window, prefix_len, q_offset,
    #  scale, stream)
    "pipit_flash_attention_bwd": (_I32, *(_P,) * 10, *(_I32,) * 13, _F32,
                                  _P),
    # (device, logits, T, E, k, idx, gates, stream)
    "pipit_topk_gating": (_I32, _P, _I64, _I32, _I32, _P, _P, _P),
    "pipit_topk_gating_narrow": (_I32, _P, _I64, _I32, _I32, _P, _P, _P),
    # (device, idx, gates, dgates, dlogits_in or null, T, E, k, dlogits,
    #  stream)
    "pipit_topk_gating_bwd": (_I32, _P, _P, _P, _P, _I64, _I32, _I32, _P,
                              _P),
    # (device, x, w, T, d, E, k, logits, idx, gates, stream)
    "pipit_router_topk": (_I32, _P, _P, _I64, _I32, _I32, _I32, _P, _P, _P,
                          _P),
}

_lib: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()
#: guards every wrapper's launch counters (a read-modify-write) and
#: ``hist_bin``'s scratch map: lane threads launch concurrently
COUNT_LOCK = threading.Lock()
#: what the last build printed (ptxas register / shared-memory / spill
#: lines) and how long it took; empty when the library was already built
BUILD_LOG = ""
BUILD_SECONDS = 0.0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): the "
                           "port's kernels are built with nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (one ``nvcc`` each, in parallel) and link the
    shared library; returns its path.  Raises on any compiler failure."""
    global BUILD_LOG, BUILD_SECONDS
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libpipit_kernels_{_digest()}.so"
    if out.exists():
        return out
    t0 = time.perf_counter()
    nvcc = _nvcc()
    procs = []
    for src in SOURCES:
        obj = BUILD_DIR / f"{Path(src).stem}.{os.getpid()}.o"
        cmd = [nvcc, *FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, _obj, p in procs:
        text, _ = p.communicate()
        logs.append(f"== {src}\n{text}")
        if p.returncode != 0:
            failed.append(src)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *[str(o) for _s, o, _p in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    os.replace(tmp, out)
    for _src, obj, _p in procs:
        obj.unlink(missing_ok=True)
    BUILD_LOG = "\n".join(logs)
    BUILD_SECONDS = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use (once, whichever
    thread asks first)."""
    global _lib
    if _lib is not None:
        return _lib
    with _LIB_LOCK:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error (its
    ``cudaGetLastError()`` after the launches)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def refuse_wrapped(what: str, *tensors) -> None:
    """Raise for a DTensor or a fake tensor: the kernels read raw device
    pointers, so a wrapper takes plain local tensors only.  Under a mesh
    the model hands each wrapper its local shards; the dry run, which
    has no device, calls the plain versions itself."""
    from torch._subclasses.fake_tensor import is_fake
    from torch.distributed.tensor import DTensor
    for t in tensors:
        if isinstance(t, DTensor):
            raise TypeError(f"{what}: a DTensor reached the kernel's "
                            f"wrapper; pass its local shard (to_local())")
        if is_fake(t):
            raise TypeError(f"{what}: a fake tensor reached the kernel's "
                            f"wrapper; call the plain version")


def raw_stream(device_index: int) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on the CUDA
    device ``device_index`` (the lookup PyTorch's own generated kernels
    use, without building a ``torch.cuda.Stream``)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(device_index)


def stream_of(t) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``t``'s
    device."""
    return raw_stream(t.device.index)
