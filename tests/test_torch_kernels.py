"""The port's kernel modules against the JAX kernels they replace.

Each kernel's plain PyTorch version (what the wrapper runs for a CPU
tensor) is held against the Pallas kernel as ``tests/test_kernels.py``
runs it on the CPU (the ``repro.kernels.ops`` wrappers in interpret mode)
and against the oracle in ``repro/kernels/ref.py`` or an exact NumPy
scatter-add.  Inputs are made from a seed with NumPy and handed to both.
Tolerance: rtol 1e-5, atol 1e-3 on sums (f32 accumulation in the Pallas
kernels, as ``tests/test_backends.py::assert_equivalent``); counts exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.ops import (histogram_counts, pair_sum_matrix,
                               segment_sum_matrix, time_profile_matrix)
from repro_torch.kernels import hist_bin, pair_sum, seg_sum, time_bin

RTOL, ATOL = 1e-5, 1e-3


def _codes(rng, n, hi, pad_frac=0.1):
    """Codes in [0, hi) with a share of -1 padding codes."""
    c = rng.integers(0, hi, size=n)
    c[rng.random(n) < pad_frac] = -1
    return c.astype(np.int32)


@pytest.mark.parametrize("n,n_seg,k", [(300, 7, 1), (777, 13, 2),
                                       (1, 3, 2), (513, 1, 3)])
def test_seg_sum_plain_matches_pallas(n, n_seg, k):
    rng = np.random.default_rng(n)
    code = _codes(rng, n, n_seg)
    vals = rng.integers(0, 50_000, size=(n, k)).astype(np.float32)
    got = seg_sum.seg_sum(torch.from_numpy(code), torch.from_numpy(vals),
                          n_seg).numpy()
    pallas = np.asarray(segment_sum_matrix(
        jnp.asarray(code), jnp.asarray(vals), n_seg=n_seg, be=256))
    exact = np.zeros((n_seg, k))
    keep = code >= 0
    np.add.at(exact, code[keep], vals[keep].astype(np.float64))
    assert got.shape == (n_seg, k) and got.dtype == np.float32
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, exact, rtol=RTOL, atol=ATOL)


def test_seg_sum_all_codes_ignored_and_out_of_range():
    code = torch.tensor([-1, -3, 5, 9], dtype=torch.int32)
    vals = torch.ones((4, 2), dtype=torch.float32)
    got = seg_sum.seg_sum(code, vals, 5)
    assert torch.equal(got, torch.zeros((5, 2)))


@pytest.mark.parametrize("n,n_a,n_b", [(300, 5, 5), (1000, 7, 11),
                                       (1, 2, 3)])
def test_pair_sum_plain_matches_pallas(n, n_a, n_b):
    rng = np.random.default_rng(n + 1)
    a = _codes(rng, n, n_a)
    b = _codes(rng, n, n_b)
    w = rng.integers(256, 8192, size=n).astype(np.float32)
    got = pair_sum.pair_sum(torch.from_numpy(a), torch.from_numpy(b),
                            torch.from_numpy(w), n_a, n_b).numpy()
    pallas = np.asarray(pair_sum_matrix(jnp.asarray(a), jnp.asarray(b),
                                        jnp.asarray(w), n_a=n_a, n_b=n_b,
                                        be=256))
    exact = np.zeros((n_a, n_b))
    keep = (a >= 0) & (b >= 0)
    np.add.at(exact, (a[keep], b[keep]), w[keep].astype(np.float64))
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, exact, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n,n_funcs,n_bins", [(300, 7, 16), (53, 3, 5),
                                              (777, 13, 10)])
def test_time_bin_plain_matches_pallas_and_oracle(n, n_funcs, n_bins):
    rng = np.random.default_rng(n + 2)
    s = (rng.random(n) * n_bins).astype(np.float32)
    e = (s + rng.random(n) * 3).astype(np.float32)
    e[::9] = s[::9]                                  # zero-duration spans
    f = _codes(rng, n, n_funcs)
    r = rng.random(n).astype(np.float32)
    t1 = float(n_bins)
    got = time_bin.time_bin(torch.from_numpy(s), torch.from_numpy(e),
                            torch.from_numpy(f), torch.from_numpy(r),
                            n_funcs, n_bins, 0.0, t1).numpy()
    pallas = np.asarray(time_profile_matrix(
        jnp.asarray(s), jnp.asarray(e), jnp.asarray(f), jnp.asarray(r),
        n_funcs=n_funcs, n_bins=n_bins, t0=0.0, t1=t1, be=256))
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    ones = np.ones(n, np.float32)
    unit = time_bin.time_bin(torch.from_numpy(s), torch.from_numpy(e),
                             torch.from_numpy(f), torch.from_numpy(ones),
                             n_funcs, n_bins, 0.0, t1).numpy()
    oracle = np.asarray(ref.time_bin_ref(
        jnp.asarray(s), jnp.asarray(e), jnp.asarray(f), n_funcs=n_funcs,
        n_bins=n_bins, t0=0.0, t1=t1))
    np.testing.assert_allclose(unit, oracle, rtol=RTOL, atol=ATOL)


def _time_three(s, e, f, n_funcs, n_bins):
    """time_bin_plain, the Pallas kernel and the oracle on the same records
    at rate 1 (the oracle has no rate)."""
    r = np.ones(len(s), np.float32)
    t1 = float(n_bins)
    got = time_bin.time_bin(*(torch.from_numpy(x) for x in (s, e, f, r)),
                            n_funcs, n_bins, 0.0, t1).numpy()
    pallas = np.asarray(time_profile_matrix(
        jnp.asarray(s), jnp.asarray(e), jnp.asarray(f), jnp.asarray(r),
        n_funcs=n_funcs, n_bins=n_bins, t0=0.0, t1=t1, be=256))
    oracle = np.asarray(ref.time_bin_ref(
        jnp.asarray(s), jnp.asarray(e), jnp.asarray(f), n_funcs=n_funcs,
        n_bins=n_bins, t0=0.0, t1=t1))
    return got, pallas, oracle


def _infinite_records(rng, n, n_funcs, n_bins):
    s = (rng.random(n) * n_bins).astype(np.float32)
    e = (s + rng.random(n) * 3).astype(np.float32)
    f = rng.integers(0, n_funcs, n).astype(np.int32)
    s[::7], e[::11] = -np.inf, np.inf
    s[3::13], e[5::17] = np.inf, -np.inf
    return s, e, f


@pytest.mark.parametrize("n,n_funcs,n_bins", [(300, 7, 16), (53, 3, 5)])
def test_time_bin_plain_infinite_coordinates_match_pallas_and_oracle(
        n, n_funcs, n_bins):
    """±inf coordinates clamp to the bins in all three, finite."""
    got, pallas, oracle = _time_three(
        *_infinite_records(np.random.default_rng(n), n, n_funcs, n_bins),
        n_funcs, n_bins)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, oracle, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("where,func", [("start", 2), ("end", 2),
                                        ("both", 2), ("start", 5),
                                        ("end", -1)])
def test_time_bin_plain_nan_row_against_pallas_and_oracle(where, func):
    """One record with a NaN coordinate among finite and infinite ones.
    The port keeps its NaN terms in that record's own row (NaN in every
    bin there, nothing for a func outside [0, n_funcs)); the reference's
    one-hot product spreads them over every row, 0 · NaN being NaN, func
    at n_funcs or above included.  A known difference (ROADMAP §C): every
    other row of the port equals the reference without that record, and
    for a func below 0 all three ignore it."""
    n_funcs, n_bins, i = 5, 8, 40
    s, e, f = _infinite_records(np.random.default_rng(9), 200, n_funcs,
                                n_bins)
    f[i] = func
    if where in ("start", "both"):
        s[i] = np.nan
    if where in ("end", "both"):
        e[i] = np.nan
    got, pallas, oracle = _time_three(s, e, f, n_funcs, n_bins)
    keep = np.arange(len(s)) != i
    clean, pallas_clean, oracle_clean = _time_three(
        s[keep], e[keep], f[keep], n_funcs, n_bins)
    np.testing.assert_allclose(clean, pallas_clean, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(clean, oracle_clean, rtol=RTOL, atol=ATOL)
    other = np.arange(n_funcs) != func
    np.testing.assert_array_equal(got[other], clean[other])
    if func < 0:
        np.testing.assert_array_equal(got, clean)
        np.testing.assert_allclose(pallas, pallas_clean, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(oracle, oracle_clean, rtol=RTOL,
                                   atol=ATOL)
        return
    if func < n_funcs:
        assert np.isnan(got[func]).all()
    assert np.isnan(pallas).all() and np.isnan(oracle).all()


@pytest.mark.parametrize("n,n_bins", [(300, 10), (777, 7), (1, 1)])
def test_hist_bin_plain_matches_pallas_exactly(n, n_bins):
    rng = np.random.default_rng(n + 3)
    idx = rng.integers(0, n_bins, size=n)
    coords = (idx + 0.5).astype(np.float32)          # the idx + 0.5 feed
    coords[::11] = -1.0                              # ignored coordinates
    got = hist_bin.hist_bin(torch.from_numpy(coords), n_bins).numpy()
    pallas = np.asarray(histogram_counts(jnp.asarray(coords),
                                         n_bins=n_bins, be=256))
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, np.rint(pallas).astype(np.int64))
    np.testing.assert_array_equal(
        got, np.bincount(idx[coords >= 0], minlength=n_bins))


def test_hist_bin_clamps_top_and_ignores_nan():
    coords = torch.tensor([0.5, 3.7, 99.0, float("nan"), -0.5],
                          dtype=torch.float32)
    assert hist_bin.hist_bin(coords, 4).tolist() == [1, 0, 0, 2]


@pytest.mark.parametrize("fn,args", [
    (seg_sum.seg_sum, (torch.zeros(3, dtype=torch.int64),
                       torch.zeros((3, 1)), 2)),
    (pair_sum.pair_sum, (torch.zeros(3, dtype=torch.int32),
                         torch.zeros(3, dtype=torch.int32),
                         torch.zeros(3, dtype=torch.float64), 2, 2)),
    (hist_bin.hist_bin, (torch.zeros(3, dtype=torch.float64), 2)),
])
def test_wrappers_reject_wrong_dtypes(fn, args):
    with pytest.raises(TypeError):
        fn(*args)


@pytest.mark.parametrize("n_bins", [1, 4, 10, 32, 33])
def test_hist_bin_plain_edge_coordinates_match_pallas(n_bins):
    """+inf and 3e9 land in the top bin (the clamp is taken before the cast
    to int), -0.0 counts in bin 0, NaN, -inf and negative coordinates are
    ignored: the plain version (what both kernel paths are held to on the
    card) equals the Pallas kernel and NumPy exactly."""
    rng = np.random.default_rng(n_bins + 7)
    x = (rng.integers(0, n_bins, 501) + 0.5).astype(np.float32)
    x[1::9], x[2::9], x[3::9] = np.inf, 3e9, -0.0
    x[4::9], x[5::9], x[6::9] = np.nan, -np.inf, -1.0
    got = hist_bin.hist_bin(torch.from_numpy(x), n_bins).numpy()
    pallas = np.asarray(histogram_counts(jnp.asarray(x), n_bins=n_bins,
                                         be=256))
    np.testing.assert_array_equal(got, np.rint(pallas).astype(np.int64))
    keep = x >= 0
    want = np.bincount(np.minimum(np.floor(x[keep]), n_bins - 1)
                       .astype(np.int64), minlength=n_bins)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == keep.sum()
    assert got[-1] >= len(x[1::9]) + len(x[2::9]) and got[0] >= len(x[3::9])
