"""The port's MoE routing and FFN against the JAX reference on the CPU.

``topk_gating_plain`` (what the ``topk_gating`` wrapper runs for a CPU
tensor) and the model's ``route_topk`` are held against the Pallas kernel
as ``tests/test_kernels.py`` runs it on the CPU (``router_topk`` in
interpret mode), against ``ref.topk_gating_ref`` (``lax.top_k``) and the
model's own ``route_topk``: indices exact, rows with exact ties included
(the lowest index wins), gates within 1e-6.  One tie differs between the
reference's two paths: ``lax.top_k`` orders +0.0 above -0.0, the Pallas
kernel's ``argmax`` (and the port) holds them equal; the comparison with
``lax.top_k`` therefore gets the logits with -0.0 written as +0.0, and
``test_topk_signed_zero_ties`` pins the kernel's behaviour.  ``moe_ffn``
is held against the JAX ``moe_ffn`` on the same float32 weights within
atol 1e-5 (f32 matmuls summed in another order), with dropping capacity,
dropless and grouped dispatch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.ops import router_topk
from repro.models import moe as jmoe
from repro_torch.kernels import topk_gating
from repro_torch.models import moe as tmoe


def _logits(T, E, seed, ties=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, E)).astype(np.float32)
    if ties:
        x[::3, 1::2] = 0.25                  # exact ties among the largest
        x[1::3] = np.round(x[1::3])          # many tied integer values
    return x


@pytest.mark.parametrize("T,E,k", [(64, 8, 2), (777, 64, 4), (32, 128, 8),
                                   (300, 60, 4), (5, 60, 4), (1, 4, 4)])
def test_topk_plain_matches_pallas_and_lax(T, E, k):
    x = _logits(T, E, T + E)
    idx, gates = topk_gating.topk_gating(torch.from_numpy(x), k)
    assert idx.dtype == torch.int32 and gates.dtype == torch.float32
    unsigned = x + np.float32(0.0)          # -0.0 + 0.0 == +0.0
    assert np.array_equal(
        idx.numpy(), topk_gating.topk_gating(torch.from_numpy(unsigned),
                                             k)[0].numpy())
    for want_idx, want_gates in (router_topk(jnp.asarray(x), k),
                                 ref.topk_gating_ref(jnp.asarray(unsigned),
                                                     k),
                                 jmoe.route_topk(jnp.asarray(unsigned), k)):
        assert np.array_equal(idx.numpy(), np.asarray(want_idx))
        np.testing.assert_allclose(gates.numpy(), np.asarray(want_gates),
                                   atol=1e-6, rtol=0)
    np.testing.assert_allclose(gates.numpy().sum(-1), 1.0, atol=1e-5)


def test_topk_signed_zero_ties():
    x = np.array([[-0.0, 0.0, -1.0, 0.0], [0.0, -0.0, -0.0, -2.0]],
                 np.float32)
    idx, gates = topk_gating.topk_gating(torch.from_numpy(x), 2)
    assert idx.tolist() == [[0, 1], [0, 1]]
    assert np.array_equal(idx.numpy(),
                          np.asarray(router_topk(jnp.asarray(x), 2)[0]))
    np.testing.assert_allclose(gates.numpy(), 0.5, atol=1e-7)


def test_route_topk_keeps_leading_axes():
    x = _logits(2 * 50, 60, 7).reshape(2, 50, 60)
    idx, gates = tmoe.route_topk(torch.from_numpy(x), 4)
    want_idx, want_gates = jmoe.route_topk(jnp.asarray(x), 4)
    assert idx.shape == (2, 50, 4)
    assert np.array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(gates.numpy(), np.asarray(want_gates),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("k,T,E", [(0, 4, 8), (9, 4, 16), (5, 4, 4)])
def test_topk_wrapper_rejects_bad_k(k, T, E):
    with pytest.raises(ValueError):
        topk_gating.topk_gating(torch.zeros(T, E), k)


def test_topk_wrapper_rejects_bad_dtype_and_rank():
    with pytest.raises(TypeError):
        topk_gating.topk_gating(torch.zeros(4, 8, dtype=torch.float64), 2)
    with pytest.raises(ValueError):
        topk_gating.topk_gating(torch.zeros(4, 8, 2), 2)


def _moe_weights(seed, T=96, d=32, E=8, f=24):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, d)).astype(np.float32)
    wr = rng.standard_normal((d, E)).astype(np.float32)
    wg, wu = (rng.standard_normal((E, d, f)).astype(np.float32) * 0.2
              for _ in range(2))
    wd = rng.standard_normal((E, f, d)).astype(np.float32) * 0.2
    return x, wr, wg, wu, wd


@pytest.mark.parametrize("kw", [
    {"capacity_factor": 1.25},                    # some assignments dropped
    {"capacity_factor": 0.25},                    # most dropped
    {"dropless": True},
    {"groups": 2, "capacity_factor": 1.0},
    {"groups": 2, "dropless": True},
    {"groups": 5},                                # T % groups != 0 → 1 group
])
@pytest.mark.parametrize("topk", [1, 2, 4])
def test_moe_ffn_matches_jax(kw, topk):
    arrs = _moe_weights(topk)
    got = tmoe.moe_ffn(*map(torch.from_numpy, arrs), topk=topk, **kw)
    want = jmoe.moe_ffn(*map(jnp.asarray, arrs), topk=topk, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("Tg,k,E,cf,dropless", [
    (4096, 4, 60, 1.25, False), (4, 4, 60, 1.25, True), (96, 2, 8, 8.0, False),
    (10, 1, 64, 1.0, False)])
def test_capacity_rule(Tg, k, E, cf, dropless):
    C = tmoe.capacity(Tg, k, E, cf, dropless)
    if dropless:
        assert C == Tg
    else:
        want = -(-max(int(Tg * k / E * cf), 1) // 8) * 8
        assert C == min(want, Tg)
