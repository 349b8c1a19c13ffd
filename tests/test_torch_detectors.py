"""The port's detector suite against :mod:`repro.core.detectors`, closed
loop against the port's own pathology injection, and the same on every
route.

Mirrors ``tests/test_detectors.py`` and ``tests/test_detector_properties.py``.
The same traces go through ``repro`` (``numpy`` backend) and, carried
across as NumPy arrays, through ``repro_torch`` on the CPU.  Findings are
keyed by (detector, location): the host detectors (``late_sender``,
``serialization``, ``imbalance_root_cause``, ``pop_efficiency``) are equal
to the reference exactly; ``stragglers`` sums in ``seg_sum`` (f32), so its
severities hold the ``benchmarks/bench_backends.py`` gate and its
explanation (the f32 sums rounded to the microsecond) is not compared.
The streamed, pack, pooled and live routes give the eager route's digest,
with each aggregator tracking the span itself (no statistics pass).
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import tracegen as rtg
from repro.core import detectors as RD
from repro_torch import Trace
from repro_torch.core import (EventFrame, executor, list_detectors, registry,
                              streaming)
from repro_torch.core import detectors as D
from repro_torch.core.constants import ET, NAME, PARTNER, PROC, TS
from repro_torch.core.detectors import FINDINGS_COLUMNS
from repro_torch.core.streaming import StreamingTrace
from repro_torch.launch.cardcheck import digest
from repro_torch.readers import write_jsonl
from repro_torch.readers.pack import PackWriter, write_pack
from repro_torch.tracegen import (PATHOLOGIES, baseline, inject,
                                  pathology_trace)

from test_torch_ops import fresh_plan_cache  # noqa: F401
from test_torch_ops import to_port

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

# magnitudes chosen so severity clears each detector's default threshold
# at the low end and grows strictly from there (the reference's)
MAGNITUDES = {
    "late_sender": (2.0, 4.0, 8.0),
    "straggler": (1.5, 2.0, 3.0),
    "serialization": (3.0, 5.0, 9.0),
    "imbalance": (2.0, 4.0, 8.0),
    "efficiency_drop": (0.3, 0.6, 1.0),
}
DETECTORS = ["late_sender", "stragglers", "serialization",
             "imbalance_root_cause", "pop_efficiency"]


def _port_pathology(pathology, **kw):
    return pathology_trace(pathology, device="cpu", **kw)


def top_finding(findings):
    assert len(findings) >= 1
    return {c: findings[c][0] for c in FINDINGS_COLUMNS}


def assert_matches_ground_truth(findings, gt):
    top = top_finding(findings)
    assert str(top["detector"]) == gt.detector
    if gt.process != -1:
        assert int(top["process"]) == gt.process
    if gt.function:
        assert str(top["function"]) == gt.function
    assert float(top["t_start"]) < gt.t_end
    assert float(top["t_end"]) > gt.t_start


def assert_findings_match(got, want, context=""):
    """Port Findings against the reference's, keyed by (detector,
    location): every field exact but the ``stragglers`` rows' severity
    (within the gate) and explanation."""
    assert list(got.columns) == list(FINDINGS_COLUMNS), context
    key = lambda f: [(str(d), str(loc))                          # noqa: E731
                     for d, loc in zip(f["detector"], f["location"])]
    kg, kw = key(got), key(want)
    assert sorted(kg) == sorted(kw), f"{context}: {kg} vs {kw}"
    at = {k: i for i, k in enumerate(kg)}
    perm = np.asarray([at[k] for k in kw], np.int64)
    strag = np.asarray([d == "stragglers" for d, _ in kw], bool)
    for c in FINDINGS_COLUMNS:
        a = np.asarray(got[c])[perm] if len(perm) else np.asarray(got[c])
        b = np.asarray(want[c])
        if c == "severity":
            np.testing.assert_array_equal(a[~strag], b[~strag],
                                          err_msg=f"{context}: {c}")
            scale = max([1.0] + list(np.abs(b[strag])))
            np.testing.assert_allclose(a[strag], b[strag], rtol=1e-4,
                                       atol=1e-6 * scale,
                                       err_msg=f"{context}: {c}")
        elif c == "explanation":
            assert list(a[~strag]) == list(b[~strag]), f"{context}: {c}"
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{context}: {c}")
    if not strag.any():
        # no f32 sum involved: the whole frame in the reference's order
        assert kg == kw, context


@pytest.fixture(scope="module")
def clean():
    return baseline(nprocs=4, iters=16, seed=0, device="cpu")


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def test_all_five_detectors_registered():
    assert set(list_detectors()) == set(DETECTORS)
    for name in list_detectors():
        spec = D.get_detector(name)
        ref = RD.get_detector(name)
        assert spec is not None and spec.name == name and spec.description
        assert (spec.category, spec.threshold) == (ref.category,
                                                   ref.threshold)
        op = registry.get_op(name)
        assert op is not None and op.scope == "trace"
        assert op.streaming is not None and op.parallel_safe, name
    for name in ("diagnose", "efficiency_metrics"):
        assert registry.get_op(name).parallel_safe
    assert D.get_detector("diagnose") is None


def test_register_detector_and_diagnose_pickup(clean):
    @D.register_detector("always_fires", category="test", threshold=0.0)
    def always_fires(trace, device="cuda"):
        """Fires once on any trace."""
        return D.Findings([{
            "detector": "always_fires", "location": "everywhere",
            "process": -1, "function": "", "severity": 0.5,
            "t_start": 0.0, "t_end": 1.0, "explanation": "test"}])

    try:
        assert "always_fires" in list_detectors()
        assert len(clean.query().run("always_fires")) == 1
        combined = clean.query().run("diagnose")
        assert "always_fires" in set(map(str, combined["detector"]))
        with pytest.raises(streaming.StreamingUnsupported,
                           match="no streaming form"):
            D._DiagnoseAgg(device="cpu")
    finally:
        registry._OP_REGISTRY.pop("always_fires", None)
        D._DETECTOR_REGISTRY.pop("always_fires", None)


# ---------------------------------------------------------------------------
# false-positive gate
# ---------------------------------------------------------------------------

def test_clean_trace_yields_no_findings(clean):
    combined = clean.diagnose()
    assert len(combined) == 0, list(zip(combined["detector"],
                                        combined["location"]))
    for name in list_detectors():
        assert len(clean.query().run(name)) == 0, name


def test_empty_findings_keep_schema(clean):
    f = clean.diagnose()
    assert tuple(f.columns) == FINDINGS_COLUMNS
    assert np.asarray(f["severity"]).dtype == np.float64
    assert np.asarray(f["process"]).dtype == np.int64
    empty = Trace.from_events(EventFrame(), device="cpu")
    for name in DETECTORS:
        got = registry.get_op(name).fn(empty, device="cpu")
        assert len(got) == 0 and tuple(got.columns) == FINDINGS_COLUMNS


# ---------------------------------------------------------------------------
# against the reference, and the closed loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pathology", sorted(PATHOLOGIES))
def test_pathology_events_equal_the_reference(pathology):
    """Both packages build the same events and ground truth from a seed."""
    ref, rgt = rtg.pathology_trace(pathology, magnitude=2.0, seed=5)
    got, gt = _port_pathology(pathology, magnitude=2.0, seed=5)
    assert rgt.__dict__ == gt.__dict__
    assert sorted(ref.events.columns) == sorted(got.events.columns)
    for c in ref.events.columns:
        np.testing.assert_array_equal(np.asarray(got.events[c]),
                                      np.asarray(ref.events[c]), err_msg=c)


@pytest.mark.parametrize("op", DETECTORS + ["diagnose"])
@pytest.mark.parametrize("pathology", sorted(PATHOLOGIES))
def test_detectors_match_reference(pathology, op):
    ref, _ = rtg.pathology_trace(pathology,
                                 magnitude=MAGNITUDES[pathology][1], seed=2)
    want = ref.query().run(op, cache=False)
    got = to_port(ref).query().run(op)
    assert_findings_match(got, want, f"{pathology}/{op}")


@pytest.mark.parametrize("app", ["gol", "tortuga", "amg_vcycle"])
def test_detectors_match_reference_on_apps(app):
    ref = getattr(rtg, app)(nprocs=4, iters=3)
    port = to_port(ref)
    for op in DETECTORS + ["diagnose"]:
        assert_findings_match(port.query().run(op),
                              ref.query().run(op, cache=False),
                              f"{app}/{op}")
    want = ref.query().run("efficiency_metrics", num_windows=7, cache=False)
    got = port.efficiency_metrics(num_windows=7)
    assert list(got.columns) == list(want.columns)
    for c in want.columns:
        np.testing.assert_array_equal(np.asarray(got[c]),
                                      np.asarray(want[c]), err_msg=c)


@pytest.mark.parametrize("pathology", sorted(PATHOLOGIES))
@pytest.mark.parametrize("seed", [0, 3])
def test_top1_recovery(pathology, seed):
    detector = PATHOLOGIES[pathology]
    tr, gt = _port_pathology(pathology, magnitude=MAGNITUDES[pathology][1],
                             seed=seed)
    assert_matches_ground_truth(tr.query().run(detector), gt)
    ref, rgt = rtg.pathology_trace(pathology,
                                   magnitude=MAGNITUDES[pathology][1],
                                   seed=seed)
    assert_matches_ground_truth(ref.query().run(detector, cache=False), rgt)


@pytest.mark.parametrize("pathology", sorted(PATHOLOGIES))
def test_severity_monotone_in_magnitude(pathology):
    detector = PATHOLOGIES[pathology]
    sevs = []
    for m in MAGNITUDES[pathology]:
        tr, _gt = _port_pathology(pathology, magnitude=m, seed=1)
        sevs.append(float(top_finding(tr.query().run(detector))["severity"]))
    assert all(a < b for a, b in zip(sevs, sevs[1:])), sevs


def test_diagnose_ranks_across_detectors():
    tr, gt = _port_pathology("straggler", magnitude=3.0, seed=2)
    combined = tr.diagnose()
    assert (np.diff(np.asarray(combined["severity"], np.float64)) <= 0).all()
    assert gt.detector in set(map(str, combined["detector"]))


def test_diagnose_subset_and_unknown():
    tr, _ = _port_pathology("straggler", magnitude=2.0, seed=0)
    sub = tr.diagnose(detectors=["stragglers"])
    assert set(map(str, sub["detector"])) <= {"stragglers"}
    assert digest(sub) == digest(tr.query().run("stragglers"))
    two = tr.diagnose(detectors=["serialization", "stragglers",
                                 "stragglers"])
    assert digest(two) == digest(tr.diagnose(detectors=["stragglers",
                                                        "serialization"]))
    with pytest.raises(ValueError, match="unknown detector"):
        tr.diagnose(detectors=["nonsense"])


def test_trace_method_equals_query_terminal():
    tr, _ = _port_pathology("imbalance", magnitude=4.0, seed=0)
    assert digest(tr.diagnose()) == digest(tr.query().run("diagnose"))
    for name in DETECTORS:
        assert digest(getattr(tr, name)()) == digest(tr.query().run(name))
    assert digest(tr.efficiency_metrics()) == digest(
        tr.query().run("efficiency_metrics"))


def test_query_plan_composes_with_detectors():
    tr, gt = _port_pathology("straggler", magnitude=2.0, seed=0)
    f = tr.query().restrict_processes([gt.process]).run("stragglers")
    assert tuple(f.columns) == FINDINGS_COLUMNS


def test_detectors_asked_for_cuda_without_a_card_raise(clean):
    import torch
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine with no card")
    for name in DETECTORS + ["diagnose", "efficiency_metrics"]:
        with pytest.raises(RuntimeError, match="CUDA"):
            clean.run(name, device="cuda")


# ---------------------------------------------------------------------------
# every route: streamed, pack, pooled, live
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def on_disk(tmp_path_factory):
    d = tmp_path_factory.mktemp("detector_routes")
    out = {}
    for pathology in sorted(PATHOLOGIES):
        tr, gt = _port_pathology(pathology,
                                 magnitude=MAGNITUDES[pathology][1], seed=0)
        jl, pk = str(d / f"{pathology}.jsonl"), str(d / f"{pathology}.pack")
        write_jsonl(tr, jl)
        write_pack(tr, pk)
        out[pathology] = (jl, pk, gt)
    return out


@pytest.mark.parametrize("pathology", sorted(PATHOLOGIES))
def test_streaming_and_pack_identical_to_eager(pathology, on_disk,
                                               monkeypatch):
    """Streamed (two chunk sizes) and pack routes give the eager digest,
    and no route reads the stream a second time for its span."""
    jl, pk, _gt = on_disk[pathology]

    def no_stats(self):
        raise AssertionError("a detector asked for a statistics pass")

    for op in (PATHOLOGIES[pathology], "diagnose", "efficiency_metrics"):
        want = digest(Trace.open(jl, device="cpu").query().run(op))
        monkeypatch.setattr(StreamingTrace, "stats", no_stats)
        got = {
            "stream(64)": Trace.open(jl, streaming=True, chunk_rows=64,
                                     device="cpu"),
            "stream(257)": Trace.open(jl, streaming=True, chunk_rows=257,
                                      device="cpu"),
            "pack-eager": Trace.open(pk, device="cpu"),
            "pack-stream": Trace.open(pk, streaming=True, chunk_rows=128,
                                      device="cpu"),
        }
        for label, handle in got.items():
            assert digest(handle.query().run(op, cache=False)) == want, \
                f"{pathology}/{op}: {label}"
        monkeypatch.undo()


@pytest.mark.parametrize("n_units", [2, 5])
@pytest.mark.parametrize("op", DETECTORS + ["diagnose",
                                            "efficiency_metrics"])
def test_work_units_identical_to_eager(on_disk, op, n_units):
    """The parallel route, units in-process (under xdist ``__main__`` has
    no file for a spawn pool): each unit's aggregator merges into the
    eager digest, seam-completed calls included."""
    for pathology in ("straggler", "efficiency_drop"):
        jl, _pk, _gt = on_disk[pathology]
        want = digest(Trace.open(jl, device="cpu").query().run(op))
        h = StreamingTrace([jl], chunk_rows=97, device="cpu", processes=2)
        spec = registry.get_op(op)
        got = executor.execute_parallel(h, (), spec, (), {"device": "cpu"},
                                        spec.streaming(device="cpu"),
                                        n_units=n_units, use_pool=False)
        assert digest(got) == want, (pathology, op, n_units)


def _grow_shards(tr, d, halves=2):
    """``tr``'s ranks as append-mode pack shards, each committed in
    ``halves`` parts; yields after each commit round."""
    procs = np.asarray(tr.events[PROC])
    writers, paths = [], []
    for r in range(int(procs.max()) + 1):
        p = os.path.join(d, f"rank_{r}.pack")
        writers.append((PackWriter.open_append(p, chunk_rows=64, fsync=False),
                        tr.events.mask(procs == r)))
        paths.append(p)
    for k in range(halves):
        for w, ev in writers:
            n = len(ev)
            w.append(ev.take(np.arange(n * k // halves,
                                       n * (k + 1) // halves)))
            w.commit()
        yield paths
    for w, _ev in writers:
        w.finalize(sidecar=False)
    yield paths


@pytest.mark.parametrize("pathology", ["late_sender", "efficiency_drop",
                                       "serialization"])
def test_live_incremental_equals_cold_and_eager(pathology, tmp_path):
    """A live handle's repeated ``diagnose`` folds only the new rows into
    the stored aggregators (no fallback to the full pass) and gives the
    cold pass's and the eager route's digest at every watermark."""
    tr, _gt = _port_pathology(pathology, magnitude=MAGNITUDES[pathology][1],
                              seed=0)
    fallbacks = streaming.INCREMENTAL_FALLBACKS
    lt = None
    for paths in _grow_shards(tr, str(tmp_path)):
        if lt is None:
            lt = Trace.open(paths, live=True, chunk_rows=100, device="cpu")
        lt.refresh()
        for op in ("diagnose", PATHOLOGIES[pathology]):
            inc = lt.run(op)
            cold = Trace.open(paths, live=True, cache=False, chunk_rows=100,
                              device="cpu").run(op)
            eager = lt.materialize().run(op)
            assert digest(inc) == digest(cold) == digest(eager), op
    assert streaming.INCREMENTAL_FALLBACKS == fallbacks


_SCRIPT = """
import sys, warnings
sys.path.insert(0, {src!r})
from repro_torch import Trace
from repro_torch.launch.cardcheck import digest


def main():
    warnings.simplefilter("error", RuntimeWarning)  # no degradation
    eager = Trace.open({paths!r}, device="cpu")
    st = Trace.open({paths!r}, streaming=True, chunk_rows=97, processes=2,
                    device="cpu")
    for op in ("diagnose", "late_sender", "pop_efficiency"):
        assert digest(st.run(op)) == digest(eager.run(op)), op
        assert len(st.units_cuda) >= 2 and not any(st.units_cuda)
    st._pool.close()
    print("POOLED", len(st.units_cuda))


if __name__ == "__main__":
    main()
"""


def test_pooled_diagnose_from_a_script_on_disk(tmp_path):
    """A real two-worker spawn pool: ``diagnose`` and two detectors over
    per-rank shards give the eager digest, no worker on CUDA."""
    tr, _gt = _port_pathology("late_sender", magnitude=4.0, seed=0)
    procs = np.asarray(tr.events[PROC])
    paths = []
    for r in range(int(procs.max()) + 1):
        p = str(tmp_path / f"rank_{r}.jsonl")
        write_jsonl(Trace.from_events(tr.events.mask(procs == r),
                                      device="cpu"), p)
        paths.append(p)
    script = tmp_path / "run_diag_pool.py"
    script.write_text(textwrap.dedent(_SCRIPT.format(src=SRC, paths=paths)))
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("POOLED"), out.stdout


# ---------------------------------------------------------------------------
# properties
# ---------------------------------------------------------------------------

@st.composite
def call_forest(draw):
    """Random per-process call forest with distinct timestamps."""
    nprocs = draw(st.integers(1, 3))
    ts_list, et_list, name_list, proc_list = [], [], [], []

    def gen(proc, t, depth, budget):
        while budget[0] > 0 and draw(st.booleans()):
            budget[0] -= 1
            name = draw(st.sampled_from(
                ["work", "solve", "MPI_Wait", "MPI_Send"]))
            ts_list.append(t)
            et_list.append("Enter")
            name_list.append(name)
            proc_list.append(proc)
            t += draw(st.integers(1, 4))
            if depth < 3:
                t = gen(proc, t, depth + 1, budget)
            ts_list.append(t)
            et_list.append("Leave")
            name_list.append(name)
            proc_list.append(proc)
            t += draw(st.integers(1, 4))
        return t

    for p in range(nprocs):
        gen(p, draw(st.integers(0, 5)), 0, [draw(st.integers(1, 12))])
    if not ts_list:
        ts_list, et_list = [0, 1], ["Enter", "Leave"]
        name_list, proc_list = ["work", "work"], [0, 0]
    return EventFrame({
        TS: np.asarray(ts_list, np.float64),
        ET: np.asarray(et_list),
        NAME: np.asarray(name_list),
        PROC: np.asarray(proc_list, np.int64),
    }).sort_by([PROC, TS])


@given(ev=call_forest(), seed=st.integers(0, 2 ** 16))
@settings(max_examples=30, deadline=None)
def test_shuffle_invariance(ev, seed):
    want = digest(Trace(ev.copy(), device="cpu").diagnose())
    rng = np.random.default_rng(seed)
    shuffled = ev.take(rng.permutation(len(ev))).sort_by([PROC, TS])
    assert digest(Trace(shuffled, device="cpu").diagnose()) == want


@given(seed=st.integers(0, 2 ** 16), magnitude=st.integers(2, 6))
@settings(max_examples=10, deadline=None)
def test_rank_relabel_equivariance(seed, magnitude):
    """Relabeling ranks permutes straggler / imbalance findings' process
    and leaves severities untouched."""
    ev, _ = inject(baseline(nprocs=4, iters=8, device="cpu"), "straggler",
                   magnitude=float(magnitude), seed=seed)
    perm = np.random.default_rng(seed).permutation(4)
    rel = ev.copy()
    rel[PROC] = perm[np.asarray(ev[PROC], np.int64)]
    partner = np.asarray(ev[PARTNER], np.int64)
    rel[PARTNER] = np.where(partner >= 0, perm[np.maximum(partner, 0)],
                            partner)
    for det in ("stragglers", "imbalance_root_cause"):
        base = Trace(ev.copy(), device="cpu").query().run(det)
        moved = Trace(rel.copy(), device="cpu").query().run(det)
        want = sorted((int(perm[p]), round(float(s), 6), str(f))
                      for p, s, f in zip(base["process"], base["severity"],
                                         base["function"]))
        got = sorted((int(p), round(float(s), 6), str(f))
                     for p, s, f in zip(moved["process"], moved["severity"],
                                        moved["function"]))
        assert got == want, det


@given(ev=call_forest(), windows=st.integers(1, 24))
@settings(max_examples=30, deadline=None)
def test_efficiency_metrics_bounded(ev, windows):
    m = Trace(ev, device="cpu").efficiency_metrics(num_windows=windows)
    for col in ("parallel_eff", "load_balance_eff", "comm_eff"):
        v = np.asarray(m[col], np.float64)
        assert ((v >= 0.0) & (v <= 1.0)).all(), col
    np.testing.assert_allclose(
        np.asarray(m["parallel_eff"]),
        np.asarray(m["load_balance_eff"]) * np.asarray(m["comm_eff"]),
        rtol=1e-12)


@given(seed=st.integers(0, 2 ** 16))
@settings(max_examples=8, deadline=None)
def test_findings_severity_always_ranked(seed):
    ev, _ = inject(baseline(nprocs=3, iters=8, device="cpu"), "straggler",
                   magnitude=2.5, seed=seed)
    f = Trace(ev, device="cpu").diagnose()
    assert (np.diff(np.asarray(f["severity"], np.float64)) <= 0).all()
