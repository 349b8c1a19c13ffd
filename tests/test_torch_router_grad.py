"""The MoE router's backward in the port against the JAX reference on the
CPU.

``topk_gating_bwd_plain`` (what the backward wrapper runs for a CPU tensor,
and what ``csrc/topk_gating_bwd.cu`` is held to on the card) against
``jax.vjp`` of the reference's ``route_topk`` (``lax.top_k``, then a
softmax), on seeded float32 logits with tied rows, with and without an
incoming gradient of the logits, within 1e-6 of the largest |dlogit|; a
row with fewer finite logits than k (which selects a chosen column again)
against autograd through ``topk_gating_plain``; ``router_topk``'s
gradients with respect to x and w through the ``autograd.Function``
classes of both routes (float32: the unfused route; bfloat16: the fused
route's Function with its plain forward) against ``jax.grad`` of the
reference's f32 einsum and ``route_topk``; and ``moe_ffn``'s gradients
for x and all four weights against ``jax.grad`` of the reference's
``moe_ffn``.  Every kernel runs its plain version here (CPU tensors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.kernels import router_topk, topk_gating
from repro_torch.models import moe as tmoe

CASES = [(8, 2), (16, 4), (60, 4), (128, 8)]


def _logits(T, E, seed, ties):
    """Seeded f32 logits; ``ties``: exact ties among a row's largest and
    rows of tied integers.  No -0.0 (``lax.top_k`` orders it below +0.0,
    the port holds the two equal)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, E)).astype(np.float32)
    if ties:
        x[::3, 1::2] = 2.5
        x[1::3] = np.round(x[1::3])
    return x + np.float32(0.0)


def _draw(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _largest(a) -> float:
    return float(np.abs(np.asarray(a, np.float64)).max())


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("incoming", [False, True])
@pytest.mark.parametrize("E,k", CASES)
def test_topk_gating_bwd_plain_matches_jax_vjp(E, k, incoming, ties):
    """The backward's plain version, and autograd through the wrapper's
    Function on a CPU tensor, against ``jax.vjp`` of ``route_topk``: the
    incoming gradient plus the softmax's backward on the chosen columns,
    within 1e-6 of the largest |dlogit|."""
    T = 97
    x = _logits(T, E, 10 * E + k, ties)
    rng = np.random.default_rng(E + k)
    dg = _draw(rng, T, k)
    din = _draw(rng, T, E) if incoming else None
    want_idx = jmoe.route_topk(jnp.asarray(x), k)[0]
    _gates, vjp = jax.vjp(lambda l: jmoe.route_topk(l, k)[1],
                          jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(dg))[0])
    if incoming:
        want = want + din
    idx, gates = topk_gating.topk_gating(torch.from_numpy(x), k)
    assert np.array_equal(idx.numpy(), np.asarray(want_idx))
    got = topk_gating.topk_gating_bwd_plain(
        idx, gates, torch.from_numpy(dg),
        None if din is None else torch.from_numpy(din), E=E)
    tol = 1e-6 * _largest(want)
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)
    # the same through the wrapper on the CPU (the Function's backward)
    assert np.array_equal(
        topk_gating.topk_gating_bwd(idx, gates, torch.from_numpy(dg),
                                    None if din is None else
                                    torch.from_numpy(din), E=E).numpy(),
        got.numpy())
    logits = torch.from_numpy(x).requires_grad_(True)
    i2, g2 = topk_gating.topk_gating(logits, k)
    assert g2.grad_fn is not None and not i2.requires_grad
    loss = (g2 * torch.from_numpy(dg)).sum()
    if incoming:
        loss = loss + (logits * torch.from_numpy(din)).sum()
    loss.backward()
    np.testing.assert_allclose(logits.grad.numpy(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("k", [2, 4, 8])
def test_duplicate_indices_add_up_to_autograds_gradient(k):
    """A row with fewer finite logits than k selects a chosen column again
    (the Pallas kernel's rule): the backward adds every slot's contribution
    to its column, in slot order, and what the repeated slots add up to is
    autograd's gradient through ``topk_gating_plain`` (which reads the
    repeated slots' values from the mask, a constant), within 1e-6 of the
    row's largest |g dg|.  An overwrite would leave the last slot's share
    alone."""
    E, T = 16, 12
    rng = np.random.default_rng(k)
    x = _draw(rng, T, E)
    x[0] = -np.inf                           # no finite logit
    x[1, 2:] = -np.inf                       # two finite logits
    x[2, :] = -np.inf
    x[2, 5] = 0.5                            # one
    x[3] = -2e30                             # all below the mask
    dg = _draw(rng, T, k)
    idx, gates = topk_gating.topk_gating_plain(torch.from_numpy(x), k)
    dup = [len(set(r)) < k for r in idx.tolist()]
    assert dup[:4] == [True, k > 2, True, True] and not any(dup[4:])
    logits = torch.from_numpy(x).requires_grad_(True)
    _i, g = topk_gating.topk_gating_plain(logits, k)
    want, = torch.autograd.grad((g * torch.from_numpy(dg)).sum(), logits)
    got = topk_gating.topk_gating_bwd_plain(idx, gates, torch.from_numpy(dg),
                                            E=E)
    scale = (gates * torch.from_numpy(dg)).abs().amax(dim=1, keepdim=True)
    assert bool(((got - want).abs() <= 1e-6 * scale).all())
    # the repeated column of row 0 takes all k slots' contributions
    c = gates[0] * (torch.from_numpy(dg[0]) - (gates[0] * torch.from_numpy(
        dg[0])).sum())
    assert abs(float(got[0, idx[0, 0]]) - float(c.sum())) <= 1e-6


def test_topk_gating_bwd_checks():
    idx = torch.zeros((3, 2), dtype=torch.int32)
    g = torch.full((3, 2), 0.5)
    with pytest.raises(ValueError, match="give dlogits or E"):
        topk_gating.topk_gating_bwd(idx, g, g)
    with pytest.raises(ValueError, match=r"\[T, k\]"):
        topk_gating.topk_gating_bwd(idx, g[:2], g, E=4)
    with pytest.raises(ValueError, match="dlogits"):
        topk_gating.topk_gating_bwd(idx, g, g, torch.zeros(2, 4))
    with pytest.raises(TypeError, match="int32 idx"):
        topk_gating.topk_gating_bwd(idx.long(), g, g, E=4)
    with pytest.raises(ValueError, match="outside"):
        topk_gating.topk_gating_bwd(idx, g, g, E=1)
    assert topk_gating.topk_gating_bwd(idx[:0], g[:0], g[:0], E=4).shape \
        == (0, 4)


def _ref_router(x, w, k, dg, dl):
    """The reference's router in f32 (``moe_ffn``'s einsum, then
    ``route_topk``), with the scalar sum(gates dg) + sum(logits dl)."""
    def f(x, w):
        logits = jnp.einsum("td,de->te", x.astype(jnp.float32),
                            w.astype(jnp.float32))
        _idx, gates = jmoe.route_topk(logits, k)
        return jnp.sum(gates * dg) + jnp.sum(logits * dl)
    return f


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,d,E,k", [(64, 32, 16, 4), (37, 48, 60, 4),
                                     (50, 64, 128, 8)])
def test_router_topk_grads_match_jax(T, d, E, k, dtype):
    """``router_topk``'s gradients through the Functions on a CPU tensor
    (float32: the unfused route, the product under autograd then
    ``topk_gating``'s Function; bfloat16: the fused route's Function,
    ``router_variant``'s pick) against ``jax.grad`` of the reference's f32
    einsum and ``route_topk``, with the gates' and the logits' own
    gradient: float32 within 1e-5 of the largest, bfloat16 within one bf16
    ulp of the largest."""
    rng = np.random.default_rng(T + E)
    x = _draw(rng, T, d)
    w = _draw(rng, d, E) * np.float32(d ** -0.5)
    dg, dl = _draw(rng, T, k), _draw(rng, T, E) * np.float32(0.1)
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    wt = torch.from_numpy(w).to(tdt).requires_grad_(True)
    route = router_topk.router_variant(tdt, d, E, k)
    assert route == ("fused" if dtype == "bfloat16" else "unfused")
    logits, idx, gates = router_topk.router_topk(xt, wt, k)
    assert not idx.requires_grad
    if route == "fused":
        assert type(gates.grad_fn).__name__ == "_RouterFusedBackward"
    else:
        assert type(gates.grad_fn).__name__ == "_TopkGatingBackward"
    ((gates * torch.from_numpy(dg)).sum()
     + (logits * torch.from_numpy(dl)).sum()).backward()
    jx = jnp.asarray(xt.detach().float().numpy()).astype(dtype)
    jw = jnp.asarray(wt.detach().float().numpy()).astype(dtype)
    gx, gw = jax.grad(_ref_router(jx, jw, k, jnp.asarray(dg),
                                  jnp.asarray(dl)), argnums=(0, 1))(jx, jw)
    for got, want in ((xt.grad, gx), (wt.grad, gw)):
        assert got.dtype == tdt
        want = np.asarray(want.astype(jnp.float32))
        big = _largest(want)
        tol = 1e-5 * big if dtype == "float32" else \
            2.0 ** (np.floor(np.log2(big)) - 7)
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                                   rtol=0)


def test_router_gates_only_needs_no_logit_gradient():
    """The fused Function asks for no zeros where the logits are unused:
    its backward gets ``None`` for them and still gives the product of the
    gates' gradient alone (held to the unfused route's autograd)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_draw(rng, 40, 32)).bfloat16().requires_grad_(True)
    w = torch.from_numpy(_draw(rng, 32, 16) * 0.2).bfloat16()
    w.requires_grad_(True)
    _l, _i, gates = router_topk.router_topk(x, w, 4)
    gates[:, 0].sum().backward()
    xf = x.detach().float().requires_grad_(True)
    wf = w.detach().float().requires_grad_(True)
    _l, _i, g2 = router_topk.router_topk(xf, wf, 4)
    g2[:, 0].sum().backward()
    for a, b in ((x.grad, xf.grad), (w.grad, wf.grad)):
        np.testing.assert_allclose(a.float().numpy(), b.numpy(),
                                   atol=2.0 ** -7 * _largest(b.numpy()))


def _moe_weights(seed, T=96, d=32, E=8, f=24):
    rng = np.random.default_rng(seed)
    x = _draw(rng, T, d)
    wr = _draw(rng, d, E)
    wg, wu = (_draw(rng, E, d, f) * np.float32(0.2) for _ in range(2))
    wd = _draw(rng, E, f, d) * np.float32(0.2)
    return x, wr, wg, wu, wd


@pytest.mark.parametrize("kw", [
    {"capacity_factor": 1.25},                    # some assignments dropped
    {"dropless": True},
    {"groups": 2, "capacity_factor": 1.25},
    {"groups": 2, "dropless": True},
])
@pytest.mark.parametrize("topk", [2, 4])
def test_moe_ffn_grads_match_jax(kw, topk):
    """``moe_ffn``'s gradients for x and the four weights in float32 (the
    router through ``topk_gating``'s Function) against ``jax.grad`` of the
    reference's ``moe_ffn`` on the same weights and output gradient, each
    within 1e-5 of its leaf's largest magnitude."""
    arrs = _moe_weights(10 * topk + len(kw))
    r = _draw(np.random.default_rng(99), *arrs[0].shape)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    out = tmoe.moe_ffn(*ts, topk=topk, **kw)
    (out * torch.from_numpy(r)).sum().backward()
    want = jax.grad(lambda *a: jnp.sum(jmoe.moe_ffn(*a, topk=topk, **kw)
                                       * r), argnums=tuple(range(5)))(
        *map(jnp.asarray, arrs))
    for name, t, w in zip(("x", "w_router", "w_gate", "w_up", "w_down"),
                          ts, want):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0,
                                   atol=1e-5 * max(_largest(w), 1e-12),
                                   err_msg=name)
