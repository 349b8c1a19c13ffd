"""The port's CUDA kernels on the card (marker ``gpu``; they skip on a
machine without CUDA, where the kernels cannot run).

Run on a GPU machine with::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain PyTorch version on the same CUDA
tensors (sums: rtol 1e-4 plus 1e-6 x the largest magnitude, the f32
accumulation gate; counts exact) and must give bit-identical output on a
second launch; the five ops on the card must match the CPU path.
"""

import numpy as np
import pytest
import torch

from repro_torch import Trace
from repro_torch.kernels import hist_bin, pair_sum, seg_sum, time_bin
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
