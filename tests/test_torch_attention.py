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

On the card, bfloat16 at D = 64 or 128 runs the tensor-core kernel, which
rounds the softmax weights P to bfloat16 before P·V (the row sums stay
f32); that kernel cannot run here, so a test-local emulation of the scan
with P rounded at that point is held to the JAX ``chunked_attention``
within the bf16 gate, 3e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import flash_attention_gqa
from repro.models import attention as jattn
from repro_torch.configs import get_config
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


@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 16, "simt"), (torch.bfloat16, 32, "simt"),
    (torch.float32, 16, "simt"), (torch.float32, 32, "simt"),
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt"),
    (torch.bfloat16, 96, "simt"), (torch.float32, 96, "simt"),
])
def test_flash_variant_rule(dtype, D, want):
    assert flash.variant(dtype, D) == want


def test_flash_variant_of_the_serving_model():
    """qwen2-moe-a2.7b serves in bf16 at head dim 128: its prefill
    attention takes the tensor-core kernel."""
    cfg = get_config("qwen2-moe-a2.7b")
    assert cfg.hd == 128
    assert flash.variant(torch.bfloat16, cfg.hd) == "wgmma"


def test_flash_variant_wrapper_checks():
    q = torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash.flash_attention_variant("mma", q, k, k)
    # a CPU tensor runs the plain version whatever the variant
    got = flash.flash_attention_variant("wgmma", q, k, k)
    assert torch.equal(got, flash.flash_attention_plain(q, k, k))


def _scan_bf16_p(q, k, v, *, causal=True, window=None, prefix_len=0,
                 q_offset=0, block=128):
    """The tensor-core kernel's arithmetic in plain PyTorch: the query
    scaled in bf16, S in f32, 128-key blocks, the online softmax in f32
    with l summed from the f32 P, and P rounded to bf16 before P·V (whose
    bf16 x bf16 products are exact in f32)."""
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    qq = (q.reshape(B, Sq, KVH, G, D) * D ** -0.5).to(q.dtype).float()
    qpos = q_offset + torch.arange(Sq)
    m = torch.full((B, KVH, G, Sq), -1e30)
    l = torch.zeros((B, KVH, G, Sq))
    acc = torch.zeros((B, KVH, G, Sq, D))
    for c0 in range(0, Sk, block):
        kc, vc = k[:, c0:c0 + block].float(), v[:, c0:c0 + block].float()
        kpos = c0 + torch.arange(kc.shape[1])
        s = torch.einsum("bqhgd,bchd->bhgqc", qq, kc)
        s = torch.where(flash.mask(qpos, kpos, causal, window, prefix_len),
                        s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhgqc,bchd->bhgqd",
                          p.to(torch.bfloat16).float(), vc)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.movedim(3, 1).reshape(B, Sq, H, D).to(q.dtype)


@pytest.mark.parametrize("B,Sq,Sk,H,KVH,D,kw", [
    (1, 200, 200, 4, 2, 64, {}),
    (2, 130, 130, 2, 2, 128, {}),
    (1, 70, 260, 4, 1, 64, {"causal": False}),
    (1, 40, 300, 4, 2, 128, {"q_offset": 260, "window": 64,
                             "prefix_len": 8}),
    (2, 1, 150, 4, 4, 128, {"q_offset": 149}),
])
def test_bf16_p_rounding_within_gate_of_jax(B, Sq, Sk, H, KVH, D, kw):
    """The one precision change of the tensor-core kernel (P in bf16 before
    P·V) keeps it within 3e-2 of the reference model's attention."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(Sq * Sk + D, B, Sq, Sk, H, KVH, D,
                                      "bfloat16")
    got = _scan_bf16_p(tq, tk, tv, **kw)
    want = jattn.chunked_attention(jq, jk, jv, **kw)
    np.testing.assert_allclose(_np(got), _np(want), atol=3e-2, rtol=0)
    # and it is a change: P in f32 (the plain version) gives other bits
    assert not torch.equal(got, flash.flash_attention_plain(tq, tk, tv,
                                                            **kw))


def test_flash_bench_needs_a_card():
    """The chip-side flash benchmark exits 2, printing no result, where
    there is no CUDA device."""
    from repro_torch.launch import flash_bench
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")
    assert flash_bench.main([]) == 2


@pytest.mark.parametrize("B,Sq,Sk,H,D,kw", [
    (2, 1, 1500, 4, 64, {"causal": False}),       # whisper cross decode
    (1, 448, 1500, 2, 64, {"causal": False}),     # whisper cross
    (1, 1500, 1500, 2, 64, {"causal": False}),    # whisper encoder
    (1, 1168, 1168, 2, 96, {}),                   # phi-3-vision prefill
])
def test_peaked_draw_gate_sees_a_lost_key_tail(B, Sq, Sk, H, D, kw):
    """On a peaked draw (``cardcheck.flash_draw``) the bf16 gate is at
    most a tenth of the outputs' mean magnitude, and a kernel that lost
    the keys past the last full 128-key tile would fail it by far: the
    plain version without them moves an output by more than ten times
    the gate."""
    from repro_torch.launch.cardcheck import flash_draw, flash_gate_share
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in flash_draw(
        rng, (B, Sq, H, D), (B, Sk, H, D), peaked=True))
    want = flash.flash_attention_plain(q, k, v, **kw).float()
    assert flash_gate_share(TOL["bfloat16"], want) <= 0.1
    keep = Sk - Sk % 128
    lost = flash.flash_attention_plain(q, k[:, :keep], v[:, :keep],
                                       **kw).float()
    assert float((lost - want).abs().max()) > 10 * TOL["bfloat16"]
