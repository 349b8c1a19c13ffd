"""int8 gradient compression (``repro_torch.distributed.compression``)
against the reference's.

* ``compress_int8`` gives exactly the reference's int8 payload ``q`` on the
  same input (with and without error feedback, sizes off the 256-element
  block, all-zero and tied blocks, bf16 input); its scales and residuals
  equal the reference's to f32 rounding (rtol 1e-6).
* On 2 and 4 gloo ranks (subprocesses from a script on disk, a
  ``FileStore`` under the test's directory), ``pairwise_compressed_mean``
  and ``compressed_psum`` equal a NumPy composition of the reference's
  ``compress_int8`` outputs: the ring in the reference's hop order (rank
  r adds r - 1's payload, then r - 2's, ...) accumulated in f32, and the
  int32 sum of the payloads with the largest scales; within f32 rounding
  (rtol 1e-6 of the largest magnitude).  Every ring hop's payload on the
  wire is ``torch.int8`` (the scales ``torch.float32``).
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.compression import compress_int8 as jax_compress
from repro.distributed.compression import decompress_int8 as jax_decompress
from repro.distributed.compression import ErrorFeedbackState as JaxEF
from repro_torch.distributed.compression import (ErrorFeedbackState,
                                                 compress_int8,
                                                 decompress_int8)

ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-6


def _draw(n, seed, kind="normal"):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(n) * 0.01).astype(np.float32)
    if kind == "zeros":
        g[:256] = 0.0                        # an all-zero block
    if kind == "ties":
        g[256:512] = 0.005                   # a block of equal values
        g[512:768] = np.round(g[512:768] * 1e3) / 1e3
    return g


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max()), 1e-30)
    assert float(np.abs(a - b).max()) <= RTOL * scale


@pytest.mark.parametrize("n,kind", [(1000, "normal"), (256, "normal"),
                                    (4096, "zeros"), (1023, "ties"),
                                    (7, "normal")])
@pytest.mark.parametrize("feedback", [False, True])
def test_compress_int8_equals_the_reference(n, kind, feedback):
    g = _draw(n, n, kind)
    r = (_draw(n, n + 1) * 0.3).astype(np.float32) if feedback else None
    q, s, ef = compress_int8(torch.from_numpy(g).reshape(-1, 1) if n == 7
                             else torch.from_numpy(g),
                             ErrorFeedbackState(torch.from_numpy(r).reshape(
                                 -1, 1) if n == 7 else torch.from_numpy(r))
                             if feedback else None)
    jg = jnp.asarray(g).reshape(-1, 1) if n == 7 else jnp.asarray(g)
    jr = (JaxEF(jnp.asarray(r).reshape(jg.shape)) if feedback else None)
    jq, js, jef = jax_compress(jg, jr)
    assert q.dtype == torch.int8 and q.shape == tuple(jq.shape)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    _close(s.numpy(), np.asarray(js))
    assert ef.residual.shape == tuple(jef.residual.shape)
    _close(ef.residual.numpy(), np.asarray(jef.residual))
    out = decompress_int8(q, s, tuple(jg.shape), torch.float32)
    _close(out.numpy(), np.asarray(jax_decompress(jq, js, jg.shape,
                                                  jnp.float32)))


def test_compress_int8_bf16_keeps_the_dtype_of_its_residual():
    g = torch.from_numpy(_draw(777, 3)).bfloat16()
    q, s, ef = compress_int8(g)
    jq, js, jef = jax_compress(jnp.asarray(g.float().numpy()).astype(
        jnp.bfloat16))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert ef.residual.dtype == torch.bfloat16
    _close(ef.residual.float().numpy(),
           np.asarray(jef.residual.astype(jnp.float32)))


RING = textwrap.dedent('''
    import json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp


    def run(rank, world, work):
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(work, "store"), world),
            rank=rank, world_size=world)
        from repro_torch.distributed import compression as C
        wire = []
        inner = dist.batch_isend_irecv

        def spy(ops):
            wire.extend(str(op.tensor.dtype) for op in ops
                        if op.op is dist.isend)
            return inner(ops)
        dist.batch_isend_irecv = spy
        g = torch.from_numpy(np.load(os.path.join(work, "g.npy"))[rank])
        mean, _ = C.pairwise_compressed_mean(g, None, world)
        psum, _ = C.compressed_psum(g, None)
        np.save(os.path.join(work, f"out{rank}.npy"),
                np.stack([mean.numpy(), psum.numpy()]))
        with open(os.path.join(work, f"wire{rank}.json"), "w") as f:
            json.dump(wire, f)
        dist.destroy_process_group()


    if __name__ == "__main__":
        work, world = sys.argv[1], int(sys.argv[2])
        mp.spawn(run, args=(world, work), nprocs=world)
''')


@pytest.mark.parametrize("world", [2, 4])
def test_ring_mean_and_psum_equal_the_reference_composition(tmp_path, world):
    n = 1000
    g = np.stack([_draw(n, 10 + r) for r in range(world)])
    np.save(tmp_path / "g.npy", g)
    script = tmp_path / "ring.py"
    script.write_text(RING)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, str(script), str(tmp_path),
                        str(world)], capture_output=True, text=True,
                       cwd=str(ROOT), env=env, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    qs, ss = [], []
    for rank in range(world):
        q, s, _ = jax_compress(jnp.asarray(g[rank]))
        qs.append(np.asarray(q))
        ss.append(np.asarray(s))
    for rank in range(world):
        got = np.load(tmp_path / f"out{rank}.npy")
        # the ring: own payload, then rank-1's, rank-2's, ... in f32
        acc = qs[rank].astype(np.float32) * ss[rank]
        for hop in range(1, world):
            src = (rank - hop) % world
            acc = acc + qs[src].astype(np.float32) * ss[src]
        want = (acc.reshape(-1)[:n] / np.float32(world)).astype(np.float32)
        _close(got[0], want)
        # int32 sum of payloads, the largest scales
        qsum = np.sum(np.stack(qs).astype(np.int32), axis=0)
        smax = np.max(np.stack(ss), axis=0)
        want = ((qsum.astype(np.float32) * smax).reshape(-1)[:n]
                / np.float32(world)).astype(np.float32)
        _close(got[1], want)
        # the whole mean is within the quantization budget of the truth
        truth = g.mean(axis=0)
        assert np.linalg.norm(got[0] - truth) / np.linalg.norm(truth) < 0.02
        sent = json.loads((tmp_path / f"wire{rank}.json").read_text())
        assert sent == ["torch.int8", "torch.float32"] * (world - 1)
