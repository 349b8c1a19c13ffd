"""The narrow paths of ``hist_bin`` and ``topk_gating``, and the model
kernels' plain versions under autograd, on the CPU.

Both wrappers pick a path from one width (``hist_bin.path(n_bins)``,
``topk_gating.path(E)``): narrow up to 32 bins or 128 columns, wide above.
Here, with no card, the path rules, the wrappers' checks and both paths by
name are tested (a CPU tensor runs the plain version on either path).  The
order in which the narrow top-k kernel selects (``_narrow_select`` below, a
plain mirror of ``csrc/topk_gating.cu``'s ``topk_narrow``: each lane scans
its four registers in ascending column, then xor steps inside the row's
G-lane segment) is held against ``topk_gating_plain`` and against a mirror
of the wide kernel (one warp a row, lane-strided columns) by a hypothesis
property over E <= 128, k <= 8, ties, signed zeros, -inf and values at or
below -1e30: indices exact, and the two mirrors' (column, value) pairs bit
for bit.  The kernels themselves run in ``tests/test_torch_gpu.py``
(marker ``gpu``).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.kernels import (flash_attention, hist_bin, router_topk,
                                 topk_gating)

NEG = np.float32(-1e30)


@pytest.mark.parametrize("n_bins,want", [
    (10, "narrow"),                 # message_histogram's default bins
    (1, "narrow"), (8, "narrow"), (16, "narrow"), (17, "narrow"),
    (32, "narrow"),                 # the threshold
    (33, "wide"), (1024, "wide"), (20_000, "wide"),
])
def test_hist_bin_path_rule(n_bins, want):
    assert hist_bin.path(n_bins) == want


@pytest.mark.parametrize("E,want", [
    (60, "narrow"),                 # qwen2-moe-a2.7b's 60 experts
    (1, "narrow"), (5, "narrow"), (32, "narrow"), (33, "narrow"),
    (64, "narrow"), (65, "narrow"),
    (128, "narrow"),                # the threshold
    (129, "wide"), (300, "wide"),
])
def test_topk_gating_path_rule(E, want):
    assert topk_gating.path(E) == want


@pytest.mark.parametrize("name", ["narrow", "wide"])
@pytest.mark.parametrize("n,n_bins", [(1, 4), (1001, 10), (5000, 32)])
def test_hist_bin_paths_by_name_on_cpu(name, n, n_bins):
    rng = np.random.default_rng(n + n_bins)
    x = (rng.integers(0, n_bins, n) + 0.5).astype(np.float32)
    x[::7] = -1.0
    x[1::11] = np.inf
    coords = torch.from_numpy(x)
    before = dict(hist_bin.PATH_LAUNCHES)
    got = hist_bin.hist_bin_path(name, coords, n_bins)
    assert torch.equal(got, hist_bin.hist_bin_plain(coords, n_bins))
    assert torch.equal(got, hist_bin.hist_bin(coords, n_bins))
    assert hist_bin.PATH_LAUNCHES == before        # no kernel on the CPU


def test_hist_bin_path_wrapper_checks():
    coords = torch.zeros(10)
    with pytest.raises(ValueError, match="at most 32 bins"):
        hist_bin.hist_bin_path("narrow", coords, 33)
    with pytest.raises(ValueError, match="unknown path"):
        hist_bin.hist_bin_path("private", coords, 10)
    with pytest.raises(ValueError):
        hist_bin.hist_bin_path("wide", coords, 0)
    with pytest.raises(TypeError):
        hist_bin.hist_bin_path("narrow", coords.double(), 10)


@pytest.mark.parametrize("name", ["narrow", "wide"])
@pytest.mark.parametrize("T,E,k", [(1, 5, 5), (300, 60, 4), (77, 128, 8)])
def test_topk_gating_paths_by_name_on_cpu(name, T, E, k):
    x = torch.from_numpy(np.random.default_rng(T + E).standard_normal(
        (T, E)).astype(np.float32))
    before = dict(topk_gating.PATH_LAUNCHES)
    idx, gates = topk_gating.topk_gating_path(name, x, k)
    want_idx, want_gates = topk_gating.topk_gating_plain(x, k)
    assert torch.equal(idx, want_idx) and torch.equal(gates, want_gates)
    assert topk_gating.PATH_LAUNCHES == before


def test_topk_gating_path_wrapper_checks():
    x = torch.zeros(4, 129)
    with pytest.raises(ValueError, match="at most 128 columns"):
        topk_gating.topk_gating_path("narrow", x, 4)
    with pytest.raises(ValueError, match="unknown path"):
        topk_gating.topk_gating_path("fused", x[:, :60], 4)
    with pytest.raises(ValueError):
        topk_gating.topk_gating_path("wide", x, 9)
    idx, _ = topk_gating.topk_gating_path("wide", x, 8)   # E > 128: wide
    assert idx.tolist() == [list(range(8))] * 4


# ---------------------------------------------------------------------------
# mirrors of the two top-k kernels' selection order
# ---------------------------------------------------------------------------

def _segment_width(E: int) -> int:
    """G, the lanes of a row on the narrow path: the smallest of 8, 16 and
    32 with 4G >= E."""
    return next(g for g in (8, 16, 32) if 4 * g >= E)


def _take(own, other):
    """The kernels' shuffle step on (value, column) pairs: the larger
    value, the lower column on ties; column -1 holds nothing."""
    (best, bi), (ob, oi) = own, other
    if oi >= 0 and (bi < 0 or ob > best or (ob == best and oi < bi)):
        return ob, oi
    return best, bi


def _butterfly(lanes):
    """xor steps G/2, ..., 1 over a segment of len(lanes) lanes: every lane
    combines its pair with its partner's, all at once."""
    off = len(lanes) // 2
    while off:
        lanes = [_take(lanes[r], lanes[r ^ off]) for r in range(len(lanes))]
        off //= 2
    assert len(set(lanes)) == 1, "lanes of one row disagree"
    return lanes[0]


def _narrow_select(row: np.ndarray, k: int):
    """``topk_narrow`` on one row: lane r holds columns 4r .. 4r + 3 in
    registers; each round every lane scans them in ascending column, the
    segment's butterfly picks the winner, and its owner sets that register
    to -1e30."""
    E = len(row)
    regs = [[row[c] for c in range(4 * r, min(4 * r + 4, E))]
            for r in range(_segment_width(E))]
    chosen, vals = [], []
    for _ in range(k):
        lanes = []
        for r, reg in enumerate(regs):
            best, bi = np.float32(0), -1
            for q, v in enumerate(reg):
                if bi < 0 or v > best:
                    best, bi = v, 4 * r + q
            lanes.append((best, bi))
        best, bi = _butterfly(lanes)
        chosen.append(bi)
        vals.append(best)
        regs[bi // 4][bi % 4] = NEG
    return chosen, vals


def _wide_select(row: np.ndarray, k: int):
    """``topk_gate`` (and ``router_topk``'s epilogue) on one row: lane l
    scans columns l, l + 32, ...; a column chosen earlier reads -1e30."""
    E = len(row)
    chosen, vals = [], []
    for _ in range(k):
        lanes = []
        for lane in range(32):
            best, bi = np.float32(0), -1
            for e in range(lane, E, 32):
                v = NEG if e in chosen else row[e]
                if bi < 0 or v > best:
                    best, bi = v, e
            lanes.append((best, bi))
        best, bi = _butterfly(lanes)
        chosen.append(bi)
        vals.append(best)
    return chosen, vals


def _check_mirrors(x: np.ndarray, k: int) -> None:
    idx, gates = topk_gating.topk_gating_plain(torch.from_numpy(x), k)
    for t, row in enumerate(x):
        n_idx, n_val = _narrow_select(row, k)
        w_idx, w_val = _wide_select(row, k)
        assert n_idx == w_idx == idx[t].tolist()
        assert np.array_equal(np.array(n_val, np.float32).view(np.uint32),
                              np.array(w_val, np.float32).view(np.uint32))
        v = np.array(n_val, np.float32)          # the f32 softmax over them
        mx = np.float32(v.max())
        with np.errstate(invalid="ignore", over="ignore"):
            ev = np.exp(v - mx)
            want = ev / np.float32(ev.sum(dtype=np.float32))
        np.testing.assert_allclose(gates[t].numpy(), want, atol=1e-6,
                                   rtol=0, equal_nan=True)


_VALUES = st.one_of(
    st.sampled_from([0.0, -0.0, 1.0, -1.0, 0.25, 2.5, 3e38, -3e38,
                     float("-inf"), -1e30, -2e30]),
    st.floats(-8, 8, width=32))


@settings(max_examples=200, deadline=None)
@given(E=st.integers(1, 128), k=st.integers(1, 8), T=st.integers(1, 3),
       palette=st.lists(_VALUES, min_size=1, max_size=6),
       seed=st.integers(0, 2 ** 16))
def test_narrow_selection_mirror_property(E, k, T, palette, seed):
    """Rows drawn from a small palette, so exact ties (signed zeros among
    them) are common; -inf and values at or below -1e30 exercise the
    re-selection of a chosen column."""
    k = min(k, E)
    x = np.random.default_rng(seed).choice(
        np.array(palette, np.float32), size=(T, E))
    _check_mirrors(x, k)


@pytest.mark.parametrize("E,k", [(60, 4), (5, 5), (33, 8), (128, 8),
                                 (127, 1)])
def test_narrow_selection_mirror_on_ties_and_signed_zeros(E, k):
    rng = np.random.default_rng(E + k)
    x = rng.standard_normal((6, E)).astype(np.float32)
    x[0] = 0.0
    x[0, ::3] = -0.0                  # +0 and -0 held equal: lowest column
    x[1] = np.round(x[1])
    x[2, 1::2] = 0.25
    x[3] = -np.inf                    # re-selects column 0
    x[4] = -1e30
    x[5, :] = -2e30
    x[5, E // 2] = -1e30
    _check_mirrors(x, k)


# ---------------------------------------------------------------------------
# the model kernels' plain versions under autograd
# ---------------------------------------------------------------------------

def test_plain_versions_stay_differentiable():
    """On a CPU tensor each of the three wrappers runs its plain version,
    whose outputs carry a grad_fn and whose backward reaches the inputs."""
    rng = np.random.default_rng(0)

    def leaf(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).requires_grad_(True)

    q, k, v = leaf(1, 8, 2, 16), leaf(1, 8, 2, 16), leaf(1, 8, 2, 16)
    flash_attention.flash_attention(q, k, v).sum().backward()
    assert all(t.grad is not None and bool(t.grad.abs().sum() > 0)
               for t in (q, k, v))
    x, w = leaf(6, 16), leaf(16, 8)
    logits, _idx, gates = router_topk.router_topk(x, w, 2)
    (logits.sum() + gates[:, 0].sum()).backward()
    assert x.grad is not None and w.grad is not None
    lg = leaf(6, 8)
    _idx, gates = topk_gating.topk_gating(lg, 3)
    gates[:, 0].sum().backward()
    assert lg.grad is not None and bool(lg.grad.abs().sum() > 0)
