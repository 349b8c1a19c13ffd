"""``stragglers``, the sixth kernel-backed op, against the reference.

The same trace goes through ``repro`` (``backend="numpy"``, the exact
reference, and ``backend="pallas"``, the TPU kernel in interpret mode) and
through ``repro_torch`` on the CPU.  Findings rows, ranks and windows must
be exact; severities agree to rtol 1e-5, atol 1e-3 (``seg_sum`` sums in
f32).  Explanations carry the f32 sums rounded to the microsecond, so they
are compared only within one package.
"""

import numpy as np
import pytest

from repro import tracegen as tg
from repro_torch import Trace
from repro_torch.core import accel, detectors
from repro_torch.core.detectors import FINDINGS_COLUMNS, is_comm_name
from repro_torch.kernels import seg_sum
from repro_torch.launch.cardcheck import digest
from repro_torch.readers import write_jsonl

from test_torch_ops import TRACES, to_port

SEVERITY = "severity"
EXACT = [c for c in FINDINGS_COLUMNS if c not in (SEVERITY, "explanation")]


def assert_findings(got, want, context=""):
    """Same rows in the same order: every column but the severity exact,
    the severity within rtol 1e-5, atol 1e-3."""
    assert list(got.columns) == list(FINDINGS_COLUMNS), context
    assert list(want.columns) == list(FINDINGS_COLUMNS), context
    assert len(got) == len(want), f"{context}: {len(got)} vs {len(want)}"
    for c in EXACT:
        np.testing.assert_array_equal(np.asarray(got[c]), np.asarray(want[c]),
                                      err_msg=f"{context}: column {c}")
    np.testing.assert_allclose(np.asarray(got[SEVERITY]),
                               np.asarray(want[SEVERITY]), rtol=1e-5,
                               atol=1e-3, err_msg=f"{context}: severity")


def _pathology(_f):
    tr, _gt = tg.pathology_trace("straggler", nprocs=4, iters=24,
                                 magnitude=2.0, seed=11)
    return tr


CASES = dict(TRACES, straggler=_pathology)


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request, tmp_path_factory):
    ref = CASES[request.param](tmp_path_factory)
    return request.param, ref, to_port(ref)


@pytest.mark.parametrize("threshold", [0.2, 0.0, -1.0])
@pytest.mark.parametrize("backend", ["numpy", "pallas"])
def test_stragglers_match_reference(pair, threshold, backend):
    name, ref, port = pair
    got = port.stragglers(threshold=threshold)
    want = ref.query().run("stragglers", cache=False, backend=backend,
                           threshold=threshold)
    assert_findings(got, want, f"{name}/{backend}/{threshold}")


def test_pathology_names_the_injected_rank():
    tr, gt = tg.pathology_trace("straggler", nprocs=4, iters=24,
                                magnitude=2.0, seed=11)
    got = to_port(tr).stragglers()
    assert len(got) >= 1
    assert int(np.asarray(got["process"])[0]) == gt.process


def test_every_rank_at_threshold_minus_one():
    """A severity of -1 or more only says the work is 0 or more, so every
    rank is reported and the busy sums are all visible."""
    port = to_port(tg.gol(nprocs=4, iters=3))
    got = port.stragglers(threshold=-1.0)
    assert sorted(np.asarray(got["process"]).tolist()) == [0, 1, 2, 3]


def test_one_seg_sum_call_on_the_private_path(monkeypatch):
    """The busy sums are one ``seg_sum`` call with K = 1 and one cell per
    rank: at 64 ranks, 64 cells, which ``seg_sum.path`` puts on the
    private path (the shape ``chip_smoke.py`` checks at main-10M)."""
    from repro_torch.tracegen import big_events
    port = Trace.from_events(big_events(nprocs=64, events_per_proc=200,
                                        calls_per_iter=10), device="cpu")
    calls = []
    real = accel.seg_sum

    def spy(code, values, n_seg, device="cuda"):
        calls.append((len(code), np.asarray(values).ndim, n_seg))
        return real(code, values, n_seg, device=device)

    monkeypatch.setattr(accel, "seg_sum", spy)
    port.stragglers()
    assert len(calls) == 1
    n, ndim, n_seg = calls[0]
    assert ndim == 1 and n_seg == 64
    assert seg_sum.path(n, n_seg) == "private"


def test_comm_names_are_left_out():
    assert is_comm_name("MPI_Allreduce") and is_comm_name("MpiSend")
    assert is_comm_name("ncclAllGather") and is_comm_name("MPI_Wait")
    assert not is_comm_name("compute_cells()")
    assert not is_comm_name("halo_exchange()")


def test_streaming_stragglers_equal_eager(tmp_path):
    tr, _gt = tg.pathology_trace("straggler", nprocs=4, iters=24,
                                 magnitude=2.0, seed=11)
    path = str(tmp_path / "t.jsonl")
    write_jsonl(to_port(tr), path)
    eager = Trace.open(path, device="cpu")
    for chunk_rows in (61, 97):
        st = Trace.open(path, streaming=True, chunk_rows=chunk_rows,
                        device="cpu")
        for threshold in (0.2, -1.0):
            assert digest(st.stragglers(threshold=threshold)) == digest(
                eager.stragglers(threshold=threshold)), (chunk_rows,
                                                         threshold)


def test_empty_trace_has_no_findings():
    from repro_torch.core import EventFrame
    got = detectors.stragglers(Trace.from_events(EventFrame(), device="cpu"),
                               device="cpu")
    assert len(got) == 0 and list(got.columns) == list(FINDINGS_COLUMNS)
