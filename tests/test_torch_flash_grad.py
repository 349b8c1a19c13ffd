"""The flash-attention gradient of the port against JAX autodiff on the CPU.

The reference trains by ``jax.grad`` through the plain chunked scan
(``repro.models.attention.chunked_attention``); the port's backward kernel
(``csrc/flash_attention_bwd.cu``) has :func:`flash_attention_bwd_plain` as
its plain version, fed the forward's row log-sum-exp.  Both that plain
backward and autograd through :func:`flash_attention_plain` (what a CPU
tensor runs) are held to ``jax.grad`` on the same seeded NumPy inputs and
output gradient: causal, non-causal, GQA, window + prefix, a padded KV
tail (Sk above the scan's 1,024-key chunk) and ``q_offset``.  Tolerances:
2e-5 x the largest gradient magnitude in float32 (f32 sums in another
order), 3e-2 x that magnitude in bfloat16 (gradients rounded to bf16 on
both sides, about 3 significant digits): ``cardcheck.flash_bwd_tol``, the
gate the card's tests and ``chip_smoke.py`` hold the kernel to.  The kernel itself runs
only on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).

The tensor-core backward (``"wgmma"``, bfloat16 at D = 64 or 128) rounds
P and dS to bfloat16 before its three gradient products.  An emulation of
that rounding in plain PyTorch (with the tensor-core forward's own
rounding of P before P·V for O) is held here to the same bf16 gate of
``jax.value_and_grad`` on every case, so the design's numerics are known
to fit the gate before any card runs it.  :func:`variant_bwd`'s table and
:func:`flash_attention_bwd_variant`'s checks are tested here too.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import chunked_attention as jax_chunked
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.cardcheck import flash_bwd_tol

#: (B, Sq, Sk, H, KVH, D, kwargs)
CASES = {
    "causal": (2, 40, 40, 4, 4, 16, {}),
    "non-causal": (1, 24, 33, 2, 2, 32, {"causal": False}),
    "gqa": (2, 37, 37, 8, 2, 16, {}),
    "window+prefix": (1, 48, 48, 4, 2, 16, {"window": 8, "prefix_len": 3}),
    "padded-tail": (1, 9, 1100, 2, 1, 16, {"q_offset": 1091}),
    "q_offset": (1, 7, 20, 2, 2, 16, {"q_offset": 13}),
    "causal-d64-gqa2": (2, 64, 64, 4, 2, 64, {}),
}
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(case, seed=0):
    B, Sq, Sk, H, KVH, D, kw = CASES[case]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Sk, KVH, D), (B, Sk, KVH, D),
                      (B, Sq, H, D))]
    return arrs, kw


def _to_torch(a, dt):
    return torch.from_numpy(a).to(dt)


@functools.lru_cache(maxsize=None)
def _jax_grads(case, tag):
    """``jax.grad`` of ``sum(chunked_attention(q, k, v) * do)`` on the
    case's seed-0 inputs (computed once per case and dtype)."""
    arrs, kw = _inputs(case)
    jdt = DTYPES[tag][1]
    q, k, v, do = (jnp.asarray(a, jdt) for a in arrs)

    def f(q, k, v):
        o = jax_chunked(q, k, v, **kw)
        return jnp.sum(o.astype(jnp.float32) * do.astype(jnp.float32))

    _loss, grads = jax.value_and_grad(f, (0, 1, 2))(q, k, v)
    return [np.asarray(g, np.float32) for g in grads]


def _check(got, want, tag):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g = g.detach().float().numpy()
        tol = flash_bwd_tol(DTYPES[tag][0], w)
        err = float(np.abs(g - w).max())
        assert err <= tol, (name, err, tol)


@pytest.mark.parametrize("tag", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_bwd_plain_matches_jax_grad(case, tag):
    tdt = DTYPES[tag][0]
    arrs, kw = _inputs(case)
    q, k, v, do = (_to_torch(a, tdt) for a in arrs)
    o, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    got = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, **kw)
    assert [g.dtype for g in got] == [tdt] * 3
    assert [g.shape for g in got] == [q.shape, k.shape, v.shape]
    _check(got, _jax_grads(case, tag), tag)


@pytest.mark.parametrize("tag", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_autograd_through_the_cpu_wrapper_matches_jax_grad(case, tag):
    """A CPU tensor runs the plain forward, through which autograd flows;
    its gradient is the reference's."""
    tdt = DTYPES[tag][0]
    arrs, kw = _inputs(case)
    q, k, v = (_to_torch(a, tdt).requires_grad_(True) for a in arrs[:3])
    do = _to_torch(arrs[3], tdt)
    before = fa.LAUNCHES_BWD
    out = fa.flash_attention(q, k, v, **kw)
    assert out.grad_fn is not None
    out.backward(do)
    assert fa.LAUNCHES_BWD == before
    _check((q.grad, k.grad, v.grad), _jax_grads(case, tag), tag)


@pytest.mark.parametrize("case", list(CASES))
def test_lse_is_the_masked_rows_logsumexp(case):
    """The log-sum-exp the forward hands the backward: each row's
    logsumexp of its visible scores, qq = round(q * scale) as the forward
    scales it."""
    arrs, kw = _inputs(case, seed=2)
    q, k, v = (torch.from_numpy(a) for a in arrs[:3])
    _out, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    s = np.einsum("bqhgd,bkhd->bhgqk",
                  arrs[0].reshape(B, Sq, KVH, G, D) * D ** -0.5, arrs[1])
    qpos = kw.get("q_offset", 0) + np.arange(Sq)
    allow = fa.mask(torch.from_numpy(qpos), torch.arange(Sk),
                    kw.get("causal", True), kw.get("window"),
                    kw.get("prefix_len", 0)).numpy()
    s = np.where(allow, s.astype(np.float64), -np.inf)
    mx = s.max(-1, keepdims=True)
    want = (mx + np.log(np.exp(s - mx).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want.reshape(B, H, Sq),
                               rtol=1e-5, atol=1e-5)


def test_bwd_wrapper_on_cpu_is_the_plain_version():
    arrs, kw = _inputs("gqa", seed=3)
    q, k, v, do = (torch.from_numpy(a) for a in arrs)
    o, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    want = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, **kw)
    before = fa.LAUNCHES_BWD
    got = fa.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    assert fa.LAUNCHES_BWD == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_plain_return_lse_keeps_the_output_and_the_wrapper_has_no_lse():
    """Asking the plain version for the log-sum-exp leaves its output the
    CPU wrapper's bits; the public wrappers take no ``return_lse`` (the
    training forward asks the kernel for it itself)."""
    import inspect
    arrs, kw = _inputs("window+prefix", seed=5)
    q, k, v = (torch.from_numpy(a) for a in arrs[:3])
    out, _lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    assert torch.equal(out, fa.flash_attention(q, k, v, **kw))
    for fn in (fa.flash_attention, fa.flash_attention_variant):
        assert "return_lse" not in inspect.signature(fn).parameters


def test_bwd_wrapper_checks_its_inputs():
    arrs, _kw = _inputs("gqa", seed=4)
    q, k, v, do = (torch.from_numpy(a) for a in arrs)
    o, lse = fa.flash_attention_plain(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="do not fit"):
        fa.flash_attention_bwd(q, k, v, o, do, lse[:, :1])
    with pytest.raises(ValueError, match="do not fit"):
        fa.flash_attention_bwd(q, k, v[:, :3], o, do, lse)
    with pytest.raises(TypeError, match="one dtype"):
        fa.flash_attention_bwd(q, k, v, o, do.bfloat16(), lse)
    with pytest.raises(TypeError, match="f32 lse"):
        fa.flash_attention_bwd(q, k, v, o, do, lse.double())


def test_flash_no_longer_refuses_grad_but_the_router_kernels_do():
    """No model kernel's wrapper refuses a gradient any more: flash
    attention has its backward kernel, and both router routes
    (``router_topk``, ``topk_gating``) theirs, ``csrc/topk_gating_bwd.cu``
    (built with the rest); ``build.refuse_grad`` is gone."""
    import inspect

    from repro_torch.kernels import router_topk, topk_gating
    assert not hasattr(build, "refuse_grad")
    for mod in (fa, router_topk, topk_gating):
        assert "refuse_grad" not in inspect.getsource(mod)
    for name, source in (("pipit_flash_attention_bwd",
                          "flash_attention_bwd.cu"),
                         ("pipit_topk_gating_bwd", "topk_gating_bwd.cu")):
        assert build.SIGNATURES[name]
        assert source in build.SOURCES


@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 32, "simt"), (torch.bfloat16, 16, "simt"),
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt"),
    (torch.float32, 16, "simt"),
])
def test_variant_bwd_table(dtype, D, want):
    """The backward picks by the forward's rule, from dtype and D alone."""
    assert fa.variant_bwd(dtype, D) == want == fa.variant(dtype, D)


def test_bwd_variant_checks_and_cpu_plain_version():
    """``flash_attention_bwd_variant`` refuses an unknown name and, for
    ``"wgmma"``, any dtype but bfloat16 or a D outside 64 / 128, on every
    device; on a CPU tensor either name runs the plain version and
    launches nothing."""
    arrs, kw = _inputs("causal-d64-gqa2", seed=6)
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in arrs)
    o, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    with pytest.raises(ValueError, match="unknown variant"):
        fa.flash_attention_bwd_variant("tiled", q, k, v, o, do, lse)
    with pytest.raises(ValueError, match="wgmma kernel takes bfloat16"):
        fa.flash_attention_bwd_variant("wgmma", *(x.float() for x in (
            q, k, v, o, do)), lse)
    with pytest.raises(ValueError, match="wgmma kernel takes bfloat16"):
        fa.flash_attention_bwd_variant("wgmma", *(x[..., :32].contiguous()
                                                  for x in (q, k, v, o, do)),
                                       lse)
    want = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, **kw)
    before = (fa.LAUNCHES_BWD, dict(fa.VARIANT_LAUNCHES_BWD))
    for name in ("wgmma", "simt"):
        got = fa.flash_attention_bwd_variant(name, q, k, v, o, do, lse, **kw)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (fa.LAUNCHES_BWD, fa.VARIANT_LAUNCHES_BWD) == before


def _wgmma_numerics(q, k, v, do, *, causal=True, window=None, prefix_len=0,
                    q_offset=0):
    """The tensor-core kernels' arithmetic in plain PyTorch: the forward
    (P rounded to bf16 before P V, l summed from the f32 P; the row
    log-sum-exp from f32) and the backward (P^T and dS^T rounded to bf16
    before dV = P^T dO, dK = dS^T qq and dQ = scale dS K; dS formed from the
    f32 P), every sum in f32.  Returns (dq, dk, dv) in bf16."""
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = D ** -0.5
    qq = (q.reshape(B, Sq, KVH, G, D) * scale).to(q.dtype).float()
    kf, vf = k.float(), v.float()
    dof = do.reshape(B, Sq, KVH, G, D).float()
    allow = fa.mask(q_offset + torch.arange(Sq), torch.arange(Sk), causal,
                    window, prefix_len)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qq, kf)
    s = torch.where(allow, s, -1e30)
    m = s.amax(-1, keepdim=True)
    p = torch.where(allow, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    bf = lambda x: x.to(torch.bfloat16).float()          # noqa: E731
    o = bf(torch.einsum("bhgqk,bkhd->bhgqd", bf(p), vf) / l)
    lse = m + torch.log(l)
    p = torch.where(allow, torch.exp(s - lse), 0.0)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", bf(p), dof)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    delta = (dof * o.permute(0, 3, 1, 2, 4)).sum(-1)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bhgqk,bkhd->bqhgd", bf(ds), kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", bf(ds), qq)
    return (dq.reshape(B, Sq, H, D).bfloat16(), dk.bfloat16(),
            dv.bfloat16())


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_p_and_ds_rounding_within_gate_of_jax(case):
    """The precision change of the tensor-core backward (P and dS in bf16
    before the gradient products), with the forward's (P in bf16 before
    P V), keeps the gradient within the bf16 gate of the reference
    model's ``jax.value_and_grad``; and it is a change: the plain version
    (P and dS in f32) gives other bits."""
    arrs, kw = _inputs(case)
    q, k, v, do = (_to_torch(a, torch.bfloat16) for a in arrs)
    got = _wgmma_numerics(q, k, v, do, **kw)
    _check(got, _jax_grads(case, "bf16"), "bf16")
    o, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    plain = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, **kw)
    assert not all(torch.equal(g, w) for g, w in zip(got, plain))
