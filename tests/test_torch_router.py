"""The port's fused MoE router and ``pair_sum``'s path rule on the CPU.

``router_topk`` (its plain version, what the wrapper runs for a CPU
tensor) is held against the reference's router on the same bf16 values:
the ``jnp.einsum`` of the ``moe_ffn`` reference on ``astype(float32)``
inputs, then ``route_topk``, ``ref.topk_gating_ref`` and the Pallas
``router_topk`` in interpret mode.  Indices exact, gates within 1e-6,
logits within ``router_topk.logit_tolerance`` (twice the worst-case
rounding of an f32 sum of d products, the two sides summing in other
orders).  ``router_variant`` is pinned for each dtype and shape, and
``pair_sum.path`` at both sides of the private path's threshold, where the
CPU result must equal an exact float64 scatter-add rounded to float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.ops import router_topk as pallas_router_topk
from repro.models import moe as jmoe
from repro_torch.kernels import pair_sum, router_topk, topk_gating


def _bf16_inputs(T, d, E, seed, zero_rows=False):
    """x ~ N(0, 1) and w ~ N(0, 1/d) rounded to bf16; returned as the torch
    bf16 tensors and the same values as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, d)).astype(np.float32)
    if zero_rows:
        x[::4] = 0.0                       # all-zero logits: ties
    w = (rng.standard_normal((d, E)) * d ** -0.5).astype(np.float32)
    tx, tw = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    return tx, tw, tx.float().numpy(), tw.float().numpy()


@pytest.mark.parametrize("T,d,E,k,zero_rows", [
    (64, 128, 60, 4, False), (300, 256, 60, 4, True), (33, 80, 8, 2, False),
    (50, 64, 128, 8, False), (7, 2048, 61, 3, True), (1, 16, 4, 4, False)])
def test_router_topk_matches_jax_router(T, d, E, k, zero_rows):
    tx, tw, x, w = _bf16_inputs(T, d, E, T + d + E, zero_rows)
    logits, idx, gates = router_topk.router_topk(tx, tw, k)
    assert logits.dtype == gates.dtype == torch.float32
    assert idx.dtype == torch.int32 and idx.shape == gates.shape == (T, k)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jw = jnp.asarray(w).astype(jnp.bfloat16)
    want = jnp.einsum("td,de->te", jx.astype(jnp.float32),
                      jw.astype(jnp.float32))
    tol = router_topk.logit_tolerance(tx, tw).numpy()
    assert np.all(np.abs(logits.numpy() - np.asarray(want)) <= tol)
    for want_idx, want_gates in (jmoe.route_topk(want, k),
                                 ref.topk_gating_ref(want, k),
                                 pallas_router_topk(want, k)):
        assert np.array_equal(idx.numpy(), np.asarray(want_idx))
        np.testing.assert_allclose(gates.numpy(), np.asarray(want_gates),
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype,d,E,k,want", [
    (torch.bfloat16, 2048, 60, 4, "fused"),      # qwen2-moe-a2.7b
    (torch.bfloat16, 2048, 128, 8, "fused"),
    (torch.bfloat16, 16, 1, 1, "fused"),
    (torch.bfloat16, 2056, 60, 4, "unfused"),    # d % 16 != 0
    (torch.bfloat16, 2048, 129, 4, "unfused"),   # E > 128
    (torch.bfloat16, 2048, 160, 9, "unfused"),   # k > 8
    (torch.float32, 2048, 60, 4, "unfused"),
    (torch.float32, 64, 8, 2, "unfused"),
    (torch.float16, 2048, 60, 4, "unfused"),
])
def test_router_variant_rule(dtype, d, E, k, want):
    assert router_topk.router_variant(dtype, d, E, k) == want


def test_router_topk_plain_is_float32_product_then_topk():
    tx, tw, x, w = _bf16_inputs(40, 96, 60, 3)
    for a, b in ((tx, tw), (tx.float(), tw.float()), (tx, tw.float())):
        logits, idx, gates = router_topk.router_topk(a, b, 4)
        want = torch.from_numpy(x) @ torch.from_numpy(w)
        assert torch.equal(logits, want)
        widx, wgates = topk_gating.topk_gating_plain(want, 4)
        assert torch.equal(idx, widx) and torch.equal(gates, wgates)


@pytest.mark.parametrize("shapes,k,err", [
    (((4, 16), (16, 8)), 9, ValueError),
    (((4, 16), (16, 8)), 0, ValueError),
    (((4, 16), (32, 8)), 2, ValueError),
    (((4, 16, 2), (16, 8)), 2, ValueError),
])
def test_router_topk_wrapper_rejects(shapes, k, err):
    x, w = (torch.zeros(s, dtype=torch.bfloat16) for s in shapes)
    with pytest.raises(err):
        router_topk.router_topk(x, w, k)


def test_router_topk_wrapper_rejects_dtype():
    with pytest.raises(TypeError):
        router_topk.router_topk(torch.zeros(4, 16, dtype=torch.float64),
                                torch.zeros(16, 8), 2)


@pytest.mark.parametrize("n,n_cells,want", [
    (4_681_408, 6 * 64, "private"),     # load_imbalance, per-process
    (579_328, 64 * 64, "private"),      # comm_matrix on the main path
    (1_000_000, 6144, "private"),       # the threshold
    (1_000_000, 6145, "sorted"),
    (4_300_000, 2048 * 2048, "sorted"),
    (1, 6144, "private"),
    (0, 384, "private"),
    (2 ** 36, 6144, "sorted"),          # partials above 2^26 floats
])
def test_pair_sum_path_rule(n, n_cells, want):
    assert pair_sum.path(n, n_cells) == want


@pytest.mark.parametrize("n_a,n_b", [(96, 64), (5, 1229)])
def test_pair_sum_both_sides_of_threshold(n_a, n_b):
    rng = np.random.default_rng(n_b)
    n = 20_000
    a = rng.integers(-1, n_a + 1, n).astype(np.int32)
    b = rng.integers(0, n_b, n).astype(np.int32)
    w = rng.integers(256, 8192, n).astype(np.float32)
    got = pair_sum.pair_sum(*map(torch.from_numpy, (a, b, w)), n_a, n_b)
    exact = np.zeros((n_a, n_b))
    keep = (a >= 0) & (a < n_a)
    np.add.at(exact, (a[keep], b[keep]), w[keep].astype(np.float64))
    assert np.array_equal(got.numpy(), exact.astype(np.float32))
    side = pair_sum.path(n, n_a * n_b)
    assert side == ("private" if n_a * n_b <= pair_sum.PRIVATE_CELLS
                    else "sorted")


def test_pair_sum_path_wrapper_checks():
    a = b = torch.zeros(8, dtype=torch.int32)
    w = torch.ones(8)
    with pytest.raises(ValueError):
        pair_sum.pair_sum_path("private", a, b, w, 5, 1229)
    with pytest.raises(ValueError):
        pair_sum.pair_sum_path("atomic", a, b, w, 2, 2)
    for name in ("private", "sorted"):
        out = pair_sum.pair_sum_path(name, a, b, w, 2, 2)
        assert out.tolist() == [[8.0, 0.0], [0.0, 0.0]]
