"""The private path of ``seg_sum`` and ``time_bin`` on the CPU.

Both wrappers pick a path as ``pair_sum`` does (``path(n, n_cells)``): per-
warp shared-memory copies of the grid up to ``PRIVATE_CELLS`` cells with
bounded CTA partials, sorted runs above.  Here, with no card, the path
rule, the wrappers' checks and both paths by name are tested (a CPU tensor
runs the plain version on either path; sums on integer weights exact), and
the arithmetic by which the ``time_bin`` kernel picks the bins a record
adds to (``_spans`` below, a plain mirror of ``csrc/time_bin.cu``'s
``span``) is held term by term against the dense overlap of
``time_bin_plain``: outside a record's bins every dense term is exactly
0, and with a finite rate and coordinates the overlap is positive on
every bin inside, so the sparse sum equals the dense one term for term.
The kernels themselves run in ``tests/test_torch_gpu.py`` (marker ``gpu``).
"""

import math
import re
from typing import Tuple

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.kernels import build, seg_sum, time_bin

INF, NAN = math.inf, math.nan


def test_every_entry_point_has_its_signature():
    """ctypes passes an int where no argtypes are set, which cuts a 64-bit
    pointer: every C entry point in csrc/ needs its signature in
    build.SIGNATURES, with one type per parameter."""
    found = {}
    for src in build.SOURCES:
        text = (build.CSRC / src).read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            found[m.group(1)] = len(m.group(2).split(","))
    assert found == {k: len(v) for k, v in build.SIGNATURES.items()}


@pytest.mark.parametrize("mod", [seg_sum, time_bin], ids=["seg_sum",
                                                          "time_bin"])
@pytest.mark.parametrize("n,n_cells,want", [
    (4_681_408, 6 * 2, "private"),      # flat_profile at main-10M
    (4_681_408, 6 * 32, "private"),     # time_profile at main-10M
    (4_300_000, 1024, "private"),
    (1_000_000, 6144, "private"),       # the threshold
    (1_000_000, 6145, "sorted"),        # one cell above it
    (500_000, 13 * 1024, "sorted"),
    (1, 6144, "private"),
    (0, 12, "private"),
    (2 ** 36, 6144, "sorted"),          # partials far above 2^26 floats
])
def test_path_rule(mod, n, n_cells, want):
    assert mod.path(n, n_cells) == want


@pytest.mark.parametrize("mod", [seg_sum, time_bin], ids=["seg_sum",
                                                          "time_bin"])
@pytest.mark.parametrize("n_cells", [12, 192, 6144])
def test_path_rule_partials_cap(mod, n_cells):
    """One row of n_cells floats a CTA of PRIVATE_TILE records: private up
    to 2^26 floats of partials, sorted from one CTA row above."""
    cap = mod.PRIVATE_PARTIALS // n_cells * mod.PRIVATE_TILE
    assert mod.path(cap, n_cells) == "private"
    assert mod.path(cap + 1, n_cells) == "sorted"


def _seg_records(rng, n, n_seg, k):
    code = rng.integers(-2, n_seg + 2, n).astype(np.int32)  # some ignored
    vals = rng.integers(0, 50_000, (n, k)).astype(np.float32)
    exact = np.zeros((n_seg, k))
    keep = (code >= 0) & (code < n_seg)
    np.add.at(exact, code[keep], vals[keep].astype(np.float64))
    return torch.from_numpy(code), torch.from_numpy(vals), exact


@pytest.mark.parametrize("name", ["private", "sorted"])
@pytest.mark.parametrize("n,n_seg,k", [(20_000, 6, 2), (5_000, 9, 1),
                                       (5_000, 9, 8), (5_000, 9, 11),
                                       (300, 1, 3), (1, 3, 2)])
def test_seg_sum_paths_by_name(name, n, n_seg, k):
    code, vals, exact = _seg_records(np.random.default_rng(n + k), n,
                                     n_seg, k)
    before = dict(seg_sum.PATH_LAUNCHES)
    got = seg_sum.seg_sum_path(name, code, vals, n_seg)
    assert got.dtype == torch.float32 and got.shape == (n_seg, k)
    assert np.array_equal(got.numpy(), exact.astype(np.float32))
    assert seg_sum.PATH_LAUNCHES == before       # the CPU launches nothing
    assert torch.equal(seg_sum.seg_sum(code, vals, n_seg), got)


def _time_records(rng, n, n_funcs, n_bins):
    """Spans on bin edges with integer rates: every overlap is a whole
    number of bins, so the float64 sums are exact in float32."""
    s = rng.integers(-2, n_bins + 2, n)
    e = s + rng.integers(0, 4, n)
    e[::97] = s[::97] + 10 * n_bins                   # spans past n_bins
    f = rng.integers(-1, n_funcs + 1, n).astype(np.int32)
    r = rng.integers(-5, 50, n)
    exact = np.zeros((n_funcs, n_bins))
    for si, ei, fi, ri in zip(s, e, f, r):
        if 0 <= fi < n_funcs:
            for j in range(max(si, 0), min(ei, n_bins)):
                exact[fi, j] += ri
    args = [torch.from_numpy(x.astype(np.float32)) for x in (s, e)]
    return (*args, torch.from_numpy(f),
            torch.from_numpy(r.astype(np.float32))), exact


@pytest.mark.parametrize("name", ["private", "sorted"])
@pytest.mark.parametrize("n,n_funcs,n_bins", [(3_000, 6, 32), (500, 1, 1),
                                              (800, 13, 7), (1, 2, 4)])
def test_time_bin_paths_by_name(name, n, n_funcs, n_bins):
    args, exact = _time_records(np.random.default_rng(n + n_bins), n,
                                n_funcs, n_bins)
    before = dict(time_bin.PATH_LAUNCHES)
    got = time_bin.time_bin_path(name, *args, n_funcs, n_bins, 0.0,
                                 float(n_bins))
    assert got.dtype == torch.float32 and got.shape == (n_funcs, n_bins)
    assert np.array_equal(got.numpy(), exact.astype(np.float32))
    assert time_bin.PATH_LAUNCHES == before
    assert torch.equal(time_bin.time_bin(*args, n_funcs, n_bins, 0.0,
                                         float(n_bins)), got)


def test_seg_sum_path_wrapper_checks():
    code = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):                  # 1,000 x 7 cells
        seg_sum.seg_sum_path("private", code, torch.ones((8, 7)), 1000)
    with pytest.raises(ValueError):
        seg_sum.seg_sum_path("atomic", code, torch.ones((8, 2)), 2)
    with pytest.raises(ValueError):
        seg_sum.seg_sum_path("private", code, torch.ones(8), 2)
    with pytest.raises(TypeError):
        seg_sum.seg_sum_path("sorted", code.long(), torch.ones((8, 1)), 2)
    for name in ("private", "sorted"):
        out = seg_sum.seg_sum_path(name, code, torch.ones((8, 2)), 2)
        assert out.tolist() == [[8.0, 8.0], [0.0, 0.0]]


def test_time_bin_path_wrapper_checks():
    s = torch.zeros(8)
    e = torch.ones(8)
    f = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):                  # 13 x 1024 cells
        time_bin.time_bin_path("private", s, e, f, e, 13, 1024, 0.0, 1024.0)
    with pytest.raises(ValueError):
        time_bin.time_bin_path("atomic", s, e, f, e, 2, 2, 0.0, 2.0)
    for t0, t1 in ((0.0, INF), (NAN, 2.0)):
        with pytest.raises(ValueError):
            time_bin.time_bin(s, e, f, e, 2, 2, t0, t1)
    for name in ("private", "sorted"):
        out = time_bin.time_bin_path(name, s, e, f, e, 2, 2, 0.0, 2.0)
        assert out.tolist() == [[8.0, 0.0], [0.0, 0.0]]


# ---------------------------------------------------------------------------
# time_bin's candidate bins against the dense form, term by term
# ---------------------------------------------------------------------------

def _spans(start: torch.Tensor, end: torch.Tensor, rate: torch.Tensor,
          n_bins: int, t0: float, t1: float
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(first, count) int64 [N]: the bins ``[first, first + count)`` where a
    record's term can be other than 0, as the private path's ``span``
    (``csrc/time_bin.cu``) finds them: a plain mirror of that kernel code,
    in the same f32 arithmetic.

    With a finite rate and no NaN coordinate the term of bin j is positive
    exactly where ``end > start``, ``hi_j > start``, ``lo_j < end`` and
    ``hi_j > lo_j``: one run of bins, since lo_j and hi_j do not fall as j
    grows.  floor / ceil of the coordinates in bin units, clamped in float
    before the conversion to int, guess its ends; two walks make them
    exact.  With unit bins (``t0 = 0``, ``t1 = n_bins``: lo_j = j, hi_j =
    j + 1) the guesses are exact and the kernel skips the walks.
    Otherwise (a NaN coordinate, or a rate of NaN or ±inf, where a term of
    0 overlap is NaN) every bin."""
    f32 = torch.float32
    dev = start.device
    t0f = torch.tensor(t0, dtype=f32, device=dev)
    bw = torch.tensor((t1 - t0) / n_bins, dtype=f32, device=dev)
    inv = (1.0 / bw if bool(bw > 0)
           else torch.tensor(0.0, dtype=f32, device=dev))
    top = float(n_bins - 1)

    def lo(j):
        return t0f + bw * j.to(f32)

    def guess(x):           # fminf(fmaxf(x, 0), top): fmaxf drops a NaN
        return torch.where(x.isnan(), 0.0, x).clamp(0.0, top).long()

    a = guess(torch.floor((start - t0f) * inv))
    b = guess(torch.ceil((end - t0f) * inv) - 1.0)
    some = (end > start) & bool(bw > 0)
    if float(t0f) == 0.0 and float(bw) == 1.0 and n_bins <= 1 << 24:
        some &= (start < n_bins) & (end > 0)
    else:
        for way, step_of in (
                (-1, lambda: (a > 0) & (lo(a - 1) + bw > start)),
                (1, lambda: (a < n_bins) & ~(lo(a) + bw > start))):
            while bool((step := step_of()).any()):
                a += way * step.long()
        for way, step_of in (
                (1, lambda: (b < n_bins - 1) & (lo(b + 1) < end)),
                (-1, lambda: (b >= 0) & ~(lo(b) < end))):
            while bool((step := step_of()).any()):
                b += way * step.long()
    dense = start.isnan() | end.isnan() | ~rate.isfinite()
    some &= ~dense
    first = torch.where(some, a, 0)
    count = torch.where(dense, n_bins,
                        torch.where(some, (b - a + 1).clamp_min(0), 0))
    return first, count


def _dense(s, e, r, n_bins, t0, t1):
    """time_bin_plain's (record, bin) overlaps and terms, [N, n_bins]."""
    bw = (t1 - t0) / n_bins
    lo = t0 + bw * torch.arange(n_bins, dtype=torch.float32)
    hi = lo + bw
    ov = (torch.minimum(e[:, None], hi[None, :])
          - torch.maximum(s[:, None], lo[None, :])).clamp_min(0.0)
    return ov, ov * r[:, None]


def _check_spans(s, e, r, n_bins, t0, t1):
    s, e, r = (torch.tensor(x, dtype=torch.float32) for x in (s, e, r))
    first, count = _spans(s, e, r, n_bins, t0, t1)
    ov, term = _dense(s, e, r, n_bins, t0, t1)
    j = torch.arange(n_bins)[None, :]
    inside = (j >= first[:, None]) & (j < (first + count)[:, None])
    assert bool(((first >= 0) & (first + count <= n_bins)).all())
    # outside its bins a record adds exactly 0 (no NaN, no inf)
    assert bool((term[~inside] == 0).all())
    # with a finite rate and coordinates the bins are exactly those of
    # positive overlap, where the bins are not degenerate (hi_j > lo_j)
    bw = (t1 - t0) / n_bins
    lo = t0 + bw * torch.arange(n_bins, dtype=torch.float32)
    wide = ((lo + bw) > lo)[None, :].expand_as(ov)
    finite = (~(s.isnan() | e.isnan()) & r.isfinite())[:, None]
    sel = finite & wide
    assert torch.equal((ov > 0)[sel], inside[sel])
    # a NaN coordinate or a rate that is not finite takes every bin
    assert bool((count[~finite[:, 0]] == n_bins).all())
    return first, count


EDGES = [  # (start, end) in bin units, 10 bins from 0
    (2.0, 3.0), (2.0, 2.0), (0.0, 10.0), (10.0, 11.0), (-1.0, 0.0),
    (-5.0, -1.0), (11.0, 15.0), (3.0, 2.0), (2.5, 2.5), (9.999999, 10.0),
    (0.0, 1e-30), (2.9999998, 3.0000002), (3.5, 1e9), (-1e9, 2.5),
    (-1e38, 1e38), (-INF, 2.5), (2.5, INF), (-INF, INF), (INF, INF),
    (-INF, -INF), (INF, -INF), (NAN, 3.0), (3.0, NAN), (NAN, NAN),
    (NAN, INF), (-INF, NAN), (4.0, 4.0000005),
]


@pytest.mark.parametrize("rate", [1.0, -2.5, 0.0, 1e-40, INF, -INF, NAN])
@pytest.mark.parametrize("t0,t1,n_bins", [
    (0.0, 10.0, 10),                # bin units, as the ops call it
    (0.3, 7.9, 13),                 # edges that round in f32
    (-1e3, 1e3, 7),
    (1e7, 1e7 + 64, 64),
    (1e8, 1e8 + 10, 10),            # f32 spacing 8 > bw: degenerate bins
    (5.0, 5.0 + 1e-5, 3),
])
def test_spans_match_dense_terms_on_edges(rate, t0, t1, n_bins):
    scale = (t1 - t0) / 10.0
    s, e = zip(*[(t0 + a * scale, t0 + b * scale) for a, b in EDGES])
    _check_spans(list(s), list(e), [rate] * len(s), n_bins, t0, t1)


@pytest.mark.parametrize("t0,t1,n_bins", [(0.3, 7.9, 13), (-1e3, 1e3, 7),
                                          (1.0 / 3, 10.0, 29)])
def test_spans_walks_fix_rounded_guesses(t0, t1, n_bins):
    """Starts and ends within two ulps of every bin edge as f32 rounds it:
    on these grids the floor / ceil guesses land one bin off both ways, so
    both walks of each end are needed."""
    bw = np.float32((t1 - t0) / n_bins)
    lo = np.float32(t0) + bw * np.arange(n_bins + 1, dtype=np.float32)
    edges = np.concatenate([lo, lo + bw])
    near = [edges]
    for way in (np.inf, -np.inf):
        x = edges
        for _ in range(2):
            x = np.nextafter(x, np.float32(way))
            near.append(x)
    pts = np.concatenate(near).astype(np.float32)
    s = np.concatenate([pts, np.full_like(pts, t0 - 1.0)])
    e = np.concatenate([np.full_like(pts, t1 + 1.0), pts])
    _check_spans(s.tolist(), e.tolist(), [1.0] * len(s), n_bins, t0, t1)


def test_spans_on_bin_units_are_floor_and_ceil():
    first, count = _check_spans([2.0, 2.5, 0.0, -INF, 3.0, NAN, 2.0],
                                [3.0, 4.0, 10.0, INF, 3.0, 1.0, 3.0],
                                [1.0] * 6 + [INF], 10, 0.0, 10.0)
    assert first.tolist() == [2, 2, 0, 0, 0, 0, 0]
    assert count.tolist() == [1, 2, 10, 10, 0, 10, 10]


_coord = st.one_of(
    st.integers(-3, 40).map(float),                      # bin edges
    st.floats(-3.0, 40.0, width=32),
    st.sampled_from([INF, -INF, NAN, 1e30, -1e30]))


@settings(max_examples=200, deadline=None)
@given(spans=st.lists(st.tuples(_coord, _coord,
                                st.floats(-10, 10, width=32)),
                      min_size=1, max_size=40),
       n_bins=st.integers(1, 37),
       t0=st.floats(-5.0, 5.0, width=32),
       width=st.floats(0.5, 60.0, width=32),
       unit=st.booleans())
def test_spans_property(spans, n_bins, t0, width, unit):
    s, e, r = zip(*spans)
    t0, t1 = (0.0, float(n_bins)) if unit else (float(t0),
                                                float(t0) + float(width))
    _check_spans(list(s), list(e), list(r), n_bins, t0, t1)


def test_time_bin_plain_nan_and_inf_rows():
    """What the kernels are held to on the card: a NaN coordinate poisons
    its own function's row and no other (the reference spreads it over
    every row: ``tests/test_torch_kernels.py``); infinite coordinates clamp
    to the bins."""
    s = torch.tensor([NAN, -INF, 1.0, 0.5])
    e = torch.tensor([2.0, INF, INF, 0.5])
    f = torch.tensor([0, 1, 2, 2], dtype=torch.int32)
    r = torch.ones(4)
    out = time_bin.time_bin(s, e, f, r, 3, 4, 0.0, 4.0)
    assert bool(out[0].isnan().all())
    assert out[1].tolist() == [1.0] * 4
    assert out[2].tolist() == [0.0, 1.0, 1.0, 1.0]
