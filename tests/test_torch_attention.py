"""The port's attention against the JAX reference on the CPU.

The port's ``chunked_attention`` runs the ``flash_attention`` kernel's
plain version for a CPU tensor; it is held against the JAX
``chunked_attention`` (the function the reference model calls) and the
Pallas kernel as ``tests/test_kernels.py`` runs it on the CPU
(``repro.kernels.ops.flash_attention_gqa`` in interpret mode), over that
file's shapes, masks, prefix, non-causal and GQA cases plus padded tails
and single-query rows.  Tolerances are ``tests/test_kernels.py``'s:
2e-5 in float32 and 3e-2 in bfloat16 (the Pallas kernel scales the query
after the f32 cast, ``chunked_attention`` and the port before it).
Inputs are made from a seed with NumPy and handed to both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import flash_attention_gqa
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as flash
from repro_torch.models import attention as tattn

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _qkv(seed, B, Sq, Sk, H, KVH, D, dtype="float32"):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Sk, KVH, D), (B, Sk, KVH, D))]
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32), np.float32)


@pytest.mark.parametrize("B,S,H,KVH,D", [
    (1, 64, 2, 1, 32), (2, 128, 4, 2, 64), (1, 192, 4, 4, 128),
    (1, 256, 8, 2, 32),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_attention_shapes(B, S, H, KVH, D, dtype):
    (jq, jk, jv), (tq, tk, tv) = _qkv(0, B, S, S, H, KVH, D, dtype)
    got = tattn.chunked_attention(tq, tk, tv)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = jattn.chunked_attention(jq, jk, jv)
    pallas = flash_attention_gqa(jq, jk, jv, bq=64, bk=64)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=0)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=tol, rtol=0)


@pytest.mark.parametrize("window,prefix", [(16, 0), (32, 8), (None, 0)])
def test_chunked_attention_masks(window, prefix):
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 1, 160, 160, 2, 2, 32)
    got = tattn.chunked_attention(tq, tk, tv, window=window,
                                  prefix_len=prefix)
    want = jattn.chunked_attention(jq, jk, jv, window=window,
                                   prefix_len=prefix)
    pallas = flash_attention_gqa(jq, jk, jv, window=window,
                                 prefix_len=prefix, bq=64, bk=32)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=0)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=2e-5, rtol=0)


def test_chunked_attention_noncausal():
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, 1, 96, 96, 2, 1, 32)
    got = tattn.chunked_attention(tq, tk, tv, causal=False)
    want = jattn.chunked_attention(jq, jk, jv, causal=False)
    pallas = flash_attention_gqa(jq, jk, jv, causal=False, bq=32, bk=32)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=0)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=2e-5, rtol=0)


@pytest.mark.parametrize("Sq,Sk,kw", [
    (1000, 1000, {}),                                   # one padded chunk
    (1100, 1100, {}),                                   # padded second chunk
    (1, 300, {"q_offset": 299}),                        # a single query
    (40, 1300, {"q_offset": 1260, "window": 64, "prefix_len": 8}),
    (50, 70, {"causal": False, "window": 20}),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_padded_tails_and_offsets(Sq, Sk, kw, dtype):
    (jq, jk, jv), (tq, tk, tv) = _qkv(Sq + Sk, 1, Sq, Sk, 4, 2, 32, dtype)
    got = flash.flash_attention(tq, tk, tv, **kw)
    want = jattn.chunked_attention(jq, jk, jv, **kw)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype], rtol=0)


def test_reference_attention_matches_jax():
    (jq, jk, jv), (tq, tk, tv) = _qkv(3, 2, 48, 48, 4, 2, 16)
    got = tattn.reference_attention(tq, tk, tv, window=8)
    want = jattn.reference_attention(jq, jk, jv, window=8)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("kv_len,window", [(0, None), (37, None), (63, None),
                                           (50, 16)])
def test_decode_attention_matches_jax(kv_len, window):
    rng = np.random.default_rng(kv_len)
    q = rng.standard_normal((2, 1, 8, 32)).astype(np.float32)
    k = rng.standard_normal((2, 64, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 64, 2, 32)).astype(np.float32)
    got = tattn.decode_attention(*map(torch.from_numpy, (q, k, v)),
                                 kv_len=kv_len, window=window)
    want = jattn.decode_attention(*map(jnp.asarray, (q, k, v)),
                                  kv_len=kv_len, window=window)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=0)


def test_mask_matches_jax():
    qpos, kpos = np.arange(5, 45), np.arange(50)
    for kw in ({"causal": True, "window": None},
               {"causal": True, "window": 7, "prefix_len": 3},
               {"causal": False, "window": 5, "prefix_len": 2}):
        got = flash.mask(torch.from_numpy(qpos), torch.from_numpy(kpos), **kw)
        want = jattn._mask(jnp.asarray(qpos), jnp.asarray(kpos), **kw)
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bad,err", [
    (dict(k=torch.zeros(1, 8, 3, 16)), ValueError),       # H % KVH
    (dict(k=torch.zeros(1, 8, 2, 8)), ValueError),        # head dims differ
    (dict(q=torch.zeros(1, 8, 4, 16, dtype=torch.float16)), TypeError),
])
def test_flash_wrapper_rejects_bad_inputs(bad, err):
    args = dict(q=torch.zeros(1, 8, 4, 16), k=torch.zeros(1, 8, 2, 16),
                v=torch.zeros(1, 8, 2, 16))
    args.update(bad)
    if "k" in bad:
        args["v"] = bad["k"]
    with pytest.raises(err):
        flash.flash_attention(args["q"], args["k"], args["v"])
