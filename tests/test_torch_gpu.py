"""The port's CUDA kernels on the card (marker ``gpu``; they skip on a
machine without CUDA, where the kernels cannot run).

Run on a GPU machine with::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain PyTorch version on the same CUDA
tensors (sums: rtol 1e-4 plus 1e-6 x the largest magnitude, the f32
accumulation gate; counts exact) and must give bit-identical output on a
second launch; the five ops on the card must match the CPU path.  The
model kernels are held to their plain versions as ``tests/test_kernels.py``
holds the Pallas kernels: flash attention within 2e-5 in float32 and 3e-2
in bfloat16, top-k indices exact and gates within 1e-6.  Flash attention in
bfloat16 at D = 64 or 128 runs the tensor-core kernel (``"wgmma"``), whose
cases below cover both head dims, lengths that are not multiples of 64 or
128, GQA, window + prefix with an offset, non-causal, one query row and
the serving shape.  ``pair_sum`` runs both of its paths (per-warp
shared-memory copies, and sorted runs) on each side of the private path's
threshold; the fused router (``router_topk``) runs at the serving model's
prefill and decode shapes, its indices and gates equal to
``topk_gating_plain`` on its own logits and its logits within
``router_topk.logit_tolerance`` of the float32 product.
"""

import numpy as np
import pytest
import torch

from repro_torch import Trace
from repro_torch.kernels import (flash_attention, hist_bin, pair_sum,
                                 router_topk, seg_sum, time_bin, topk_gating)
from repro_torch.tracegen import big_events

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only there")
    return torch.device("cuda")


def _close(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    scale = max(float(b.abs().max()) if b.numel() else 0.0, 1.0)
    assert torch.allclose(a, b, rtol=1e-4, atol=1e-6 * scale)


def _check(kernel, plain, args, exact=False):
    got, again, want = kernel(*args), kernel(*args), plain(*args)
    assert torch.equal(got, again), "relaunch not bit-identical"
    if exact:
        assert torch.equal(got.cpu(), want.cpu())
    else:
        _close(got, want)


@pytest.mark.parametrize("n,n_seg,k", [(1, 3, 1), (1000, 7, 2),
                                       (300_000, 1024, 2)])
def test_seg_sum_kernel(cuda, n, n_seg, k):
    rng = np.random.default_rng(n)
    code = torch.from_numpy(rng.integers(-1, n_seg, n).astype(np.int32))
    vals = torch.from_numpy(rng.random((n, k)).astype(np.float32) * 1e4)
    before = seg_sum.LAUNCHES
    _check(seg_sum.seg_sum, seg_sum.seg_sum_plain,
           (code.to(cuda), vals.to(cuda), n_seg))
    assert seg_sum.LAUNCHES == before + 2


@pytest.mark.parametrize("n,n_a,n_b", [(1, 2, 2), (1000, 5, 7),
                                       (300_000, 1024, 1024)])
def test_pair_sum_kernel(cuda, n, n_a, n_b):
    rng = np.random.default_rng(n)
    a = torch.from_numpy(rng.integers(-1, n_a, n).astype(np.int32))
    b = torch.from_numpy(rng.integers(0, n_b, n).astype(np.int32))
    w = torch.from_numpy(rng.random(n).astype(np.float32) * 1e4)
    _check(pair_sum.pair_sum, pair_sum.pair_sum_plain,
           (a.to(cuda), b.to(cuda), w.to(cuda), n_a, n_b))


@pytest.mark.parametrize("n,n_funcs,n_bins", [(1, 2, 4), (1000, 7, 10),
                                              (300_000, 13, 32)])
def test_time_bin_kernel(cuda, n, n_funcs, n_bins):
    rng = np.random.default_rng(n)
    s = rng.random(n) * n_bins
    e = np.minimum(s + rng.exponential(0.05, n), n_bins)
    e[::7] = s[::7]
    f = rng.integers(-1, n_funcs, n).astype(np.int32)
    r = rng.random(n)
    args = [torch.from_numpy(x.astype(np.float32)).to(cuda)
            for x in (s, e)] + [torch.from_numpy(f).to(cuda),
                                torch.from_numpy(r.astype(np.float32))
                                .to(cuda)]
    _check(time_bin.time_bin, time_bin.time_bin_plain,
           (*args, n_funcs, n_bins, 0.0, float(n_bins)))


@pytest.mark.parametrize("n,n_bins", [(1, 1), (1000, 7), (300_000, 1024),
                                      (300_000, 20_000)])
def test_hist_bin_kernel(cuda, n, n_bins):
    rng = np.random.default_rng(n)
    x = (rng.integers(0, n_bins, n) + 0.5).astype(np.float32)
    x[::13] = -1.0
    _check(hist_bin.hist_bin, hist_bin.hist_bin_plain,
           (torch.from_numpy(x).to(cuda), n_bins), exact=True)


def test_ops_on_card_match_cpu_path(cuda):
    t = Trace.from_events(big_events(nprocs=8, events_per_proc=20_000,
                                     seed=4), device=cuda)
    counts, edges = t.message_histogram()
    cpu_counts, cpu_edges = t.message_histogram(device="cpu")
    assert np.array_equal(counts, cpu_counts)
    assert np.array_equal(edges, cpu_edges)
    np.testing.assert_allclose(t.comm_matrix(), t.comm_matrix(device="cpu"),
                               rtol=1e-4)
    a = t.flat_profile(metrics=("time.exc", "time.inc"))
    b = t.flat_profile(metrics=("time.exc", "time.inc"), device="cpu")
    assert list(a["Name"]) == list(b["Name"])
    assert np.array_equal(a["count"], b["count"])
    np.testing.assert_allclose(a["time.inc"], b["time.inc"], rtol=1e-4)
    p = t.time_profile(num_bins=16)
    q = t.time_profile(num_bins=16, device="cpu")
    assert sorted(p.columns) == sorted(q.columns)
    for c in q.columns:
        np.testing.assert_allclose(p[c], q[c], rtol=1e-4,
                                   atol=1e-6 * float(np.abs(q[c]).max()))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("B,Sq,Sk,H,KVH,D,kw", [
    (2, 128, 128, 4, 4, 64, {}),                              # causal
    (1, 160, 160, 2, 2, 32, {"window": 64, "prefix_len": 8}),
    (1, 96, 96, 2, 1, 32, {"causal": False}),
    (2, 200, 200, 8, 2, 128, {}),                             # GQA 4
    (1, 1000, 1000, 4, 4, 128, {}),                           # padded tail
    (2, 1, 300, 4, 2, 128, {"q_offset": 299}),                # one query
    (1, 77, 77, 2, 2, 64, {"window": 16}),
    (4, 33, 33, 4, 4, 16, {}),                                # smoke width
    (1, 40, 1300, 4, 2, 64, {"q_offset": 1260, "window": 64,
                             "prefix_len": 8}),
    (2, 50, 70, 4, 4, 32, {"causal": False, "window": 20}),
])
def test_flash_attention_kernel(cuda, dtype, tol, B, Sq, Sk, H, KVH, D, kw):
    rng = np.random.default_rng(Sq + Sk + D)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda, dtype) for s in ((B, Sq, H, D), (B, Sk, KVH, D),
                                          (B, Sk, KVH, D)))
    before = flash_attention.LAUNCHES
    got = flash_attention.flash_attention(q, k, v, **kw)
    again = flash_attention.flash_attention(q, k, v, **kw)
    want = flash_attention.flash_attention_plain(q, k, v, **kw)
    assert flash_attention.LAUNCHES == before + 2
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, again), "relaunch not bit-identical"
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


@pytest.mark.parametrize("B,Sq,Sk,H,KVH,D,kw", [
    (2, 128, 128, 4, 4, 64, {}),                              # D = 64
    (2, 256, 256, 4, 4, 128, {}),                             # D = 128
    (1, 1000, 1000, 4, 4, 128, {}),                           # tails
    (1, 77, 200, 4, 4, 64, {"causal": False}),
    (2, 200, 200, 8, 2, 128, {}),                             # GQA 4
    (2, 300, 300, 8, 2, 64, {}),                              # GQA 4
    (1, 40, 1300, 4, 2, 64, {"q_offset": 1260, "window": 64,
                             "prefix_len": 8}),
    (2, 300, 300, 4, 4, 128, {"q_offset": 5, "window": 100,
                              "prefix_len": 4}),
    (2, 512, 700, 8, 8, 128, {"causal": False}),              # non-causal
    (4, 1, 2000, 16, 16, 128, {"q_offset": 1999}),            # Sq = 1
    (4, 872, 872, 16, 16, 128, {}),                           # serving
])
def test_flash_attention_tensor_core_kernel(cuda, B, Sq, Sk, H, KVH, D, kw):
    rng = np.random.default_rng(Sq * Sk + D)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda, torch.bfloat16)
               for s in ((B, Sq, H, D), (B, Sk, KVH, D), (B, Sk, KVH, D)))
    assert flash_attention.variant(q.dtype, D) == "wgmma"
    before = flash_attention.VARIANT_LAUNCHES["wgmma"]
    got = flash_attention.flash_attention(q, k, v, **kw)
    again = flash_attention.flash_attention(q, k, v, **kw)
    want = flash_attention.flash_attention_plain(q, k, v, **kw)
    assert flash_attention.VARIANT_LAUNCHES["wgmma"] == before + 2
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert torch.equal(got, again), "relaunch not bit-identical"
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=0)


def test_flash_attention_variants_agree(cuda):
    """The SIMT kernel on the same bf16 inputs: both within the gate of
    the plain version, and the wgmma kernel refuses what it cannot take."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda, torch.bfloat16)
               for s in ((2, 300, 8, 128), (2, 300, 2, 128), (2, 300, 2, 128)))
    want = flash_attention.flash_attention_plain(q, k, v).float()
    for name in ("simt", "wgmma"):
        got = flash_attention.flash_attention_variant(name, q, k, v)
        torch.testing.assert_close(got.float(), want, atol=3e-2, rtol=0)
    with pytest.raises(ValueError):
        flash_attention.flash_attention_variant("wgmma", q.float(),
                                                k.float(), v.float())
    with pytest.raises(ValueError):
        flash_attention.flash_attention_variant("wgmma", q[..., :32]
                                                .contiguous(),
                                                k[..., :32].contiguous(),
                                                v[..., :32].contiguous())


@pytest.mark.parametrize("T,E,k", [(4096, 60, 4), (32, 128, 8), (777, 64, 4),
                                   (5, 60, 4), (1000, 300, 2)])
def test_topk_gating_kernel(cuda, T, E, k):
    rng = np.random.default_rng(T + E)
    x = rng.standard_normal((T, E)).astype(np.float32)
    x[::3, 1::2] = 0.25                     # rows with exact ties
    x[1::3] = np.round(x[1::3])
    logits = torch.from_numpy(x).to(cuda)
    before = topk_gating.LAUNCHES
    idx, gates = topk_gating.topk_gating(logits, k)
    idx2, gates2 = topk_gating.topk_gating(logits, k)
    want_idx, want_gates = topk_gating.topk_gating_plain(logits, k)
    assert topk_gating.LAUNCHES == before + 2
    assert torch.equal(idx, idx2) and torch.equal(gates, gates2)
    assert torch.equal(idx.cpu(), want_idx.cpu())
    torch.testing.assert_close(gates, want_gates, atol=1e-6, rtol=0)


def _pair_records(rng, n, n_a, n_b, order=None):
    a = rng.integers(-1, n_a + 1, n).astype(np.int32)   # some out of range
    b = rng.integers(0, n_b, n).astype(np.int32)
    if order == "sorted":            # long runs of one cell, as the ops give
        a, b = np.sort(a), np.sort(b)
    elif order == "one cell":
        a[:], b[:] = n_a - 1, n_b - 1
    w = (rng.random(n) * 1e4).astype(np.float32)
    return [torch.from_numpy(x) for x in (a, b, w)]


@pytest.mark.parametrize("n,n_a,n_b,order", [
    (1, 2, 2, None), (1000, 5, 7, None), (300_000, 6, 64, None),
    (300_000, 6, 64, "sorted"), (100_000, 3, 3, "one cell"),
    (200_000, 12, 64, None),        # the largest grid with mask tables
    (300_000, 64, 64, None), (70_000, 96, 64, None),   # at the threshold
])
@pytest.mark.parametrize("name", ["private", "sorted"])
def test_pair_sum_paths(cuda, n, n_a, n_b, order, name):
    rng = np.random.default_rng(n + n_a)
    a, b, w = (x.to(cuda) for x in _pair_records(rng, n, n_a, n_b, order))
    assert pair_sum.path(n, n_a * n_b) == "private"
    before = pair_sum.PATH_LAUNCHES[name]
    _check(lambda *args: pair_sum.pair_sum_path(name, *args),
           pair_sum.pair_sum_plain, (a, b, w, n_a, n_b))
    assert pair_sum.PATH_LAUNCHES[name] == before + 2


@pytest.mark.parametrize("n,n_a,n_b", [(70_000, 5, 1229), (300_000, 2048,
                                                           2048)])
def test_pair_sum_above_threshold_sorted(cuda, n, n_a, n_b):
    rng = np.random.default_rng(n + n_a)
    a, b, w = (x.to(cuda) for x in _pair_records(rng, n, n_a, n_b))
    assert pair_sum.path(n, n_a * n_b) == "sorted"
    before = pair_sum.PATH_LAUNCHES["sorted"]
    _check(pair_sum.pair_sum, pair_sum.pair_sum_plain, (a, b, w, n_a, n_b))
    assert pair_sum.PATH_LAUNCHES["sorted"] == before + 2
    with pytest.raises(ValueError):
        pair_sum.pair_sum_path("private", a, b, w, n_a, n_b)


@pytest.mark.parametrize("T,d,E,k", [
    (3488, 2048, 60, 4),            # qwen2-moe-a2.7b prefill, one wave
    (4, 2048, 60, 4),               # its decode step
    (256, 2048, 60, 4),             # 16 row tiles: the depth split over
    (257, 2048, 60, 4),             # a cluster of 8 CTAs, and past it
    (777, 256, 128, 8), (4, 1024, 128, 8), (33, 80, 8, 2), (1000, 64, 33, 1),
    (17, 2064, 61, 3),
])
def test_router_topk_kernel(cuda, T, d, E, k):
    rng = np.random.default_rng(T + d + E)
    x = torch.from_numpy(rng.standard_normal((T, d)).astype(np.float32))
    x[::5] = 0.0                        # all-zero logits: every column ties
    w = torch.from_numpy(rng.standard_normal((d, E)).astype(np.float32)
                         * 0.02)
    x, w = x.to(cuda).bfloat16(), w.to(cuda).bfloat16()
    assert router_topk.router_variant(x.dtype, d, E, k) == "fused"
    before = router_topk.LAUNCHES
    logits, idx, gates = router_topk.router_topk(x, w, k)
    again = router_topk.router_topk(x, w, k)
    assert router_topk.LAUNCHES == before + 2
    assert all(torch.equal(p, q) for p, q in zip((logits, idx, gates),
                                                 again))
    want_idx, want_gates = topk_gating.topk_gating_plain(logits, k)
    assert torch.equal(idx, want_idx)
    torch.testing.assert_close(gates, want_gates, atol=1e-6, rtol=0)
    want = x.float() @ w.float()
    assert bool(((logits - want).abs()
                 <= router_topk.logit_tolerance(x, w)).all())
    assert idx[::5].tolist() == [list(range(k))] * len(idx[::5])


def test_router_topk_unfused_route_launches_topk_gating(cuda):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((300, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 60)).astype(np.float32))
    x, w = x.to(cuda), w.to(cuda)
    before = (router_topk.LAUNCHES, topk_gating.LAUNCHES,
              router_topk.VARIANT_CALLS["unfused"])
    logits, idx, gates = router_topk.router_topk(x, w, 4)
    assert (router_topk.LAUNCHES, topk_gating.LAUNCHES,
            router_topk.VARIANT_CALLS["unfused"]) == (
        before[0], before[1] + 1, before[2] + 1)
    want = router_topk.router_topk_plain(x, w, 4)
    torch.testing.assert_close(logits, want[0], atol=1e-5, rtol=0)
    assert torch.equal(idx, want[1])
