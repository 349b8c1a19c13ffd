"""The rest of the paper's analysis API in the port, against the reference.

The same traces go through ``repro`` and through ``repro_torch`` on the
CPU (carried across by ``convert.events_from_columns``): the Fig. 1 trace
of ``tests/test_system.py``, the application generators and a small
``big_trace`` of 4 ranks.

* The host ops (``idle_time``, ``comm_by_process``, ``comm_over_time``,
  ``comm_comp_breakdown``, ``logical_steps``, ``calculate_lateness``,
  ``lateness_by_process``, ``critical_path_analysis``,
  ``activity_series``, ``detect_pattern``) are **exact**: every column
  equal, in the reference's column order and row order.
* ``multirun_analysis`` reduces each run with ``seg_sum`` (f32): it is
  held within the ``benchmarks/bench_backends.py`` gate of the reference,
  labels and columns exact, except where an f32 near-tie between two
  functions' totals reorders columns (ROADMAP §C), pinned below on a
  trace built to have one.
* The paper's claims of ``tests/test_ops.py`` hold on the port's own
  generators.
"""

import numpy as np
import pytest
import torch

from repro import tracegen as rtg
from repro.core.trace import Trace as RefTrace
from repro.tracegen.builder import TraceBuilder as RefBuilder
from repro_torch import Trace, TraceSet
from repro_torch import tracegen as tg
from repro_torch.core import NAME, PROC
from repro_torch.launch.cardcheck import gate

from test_system import fig1_trace
from test_torch_ops import fresh_plan_cache  # noqa: F401
from test_torch_ops import to_port

#: generator name -> (reference trace factory, start_event for
#: ``detect_pattern``)
GENERATORS = {
    "fig1": (lambda: fig1_trace(3), "foo()"),
    "gol": (lambda: rtg.gol(nprocs=4, iters=6, imbalance=0.5),
            "compute_cells()"),
    "stencil3d": (lambda: rtg.stencil3d(nprocs=8, iters=3),
                  "kernel_update()"),
    "amg_vcycle": (lambda: rtg.amg_vcycle(nprocs=6, iters=3), "smooth_l0()"),
    "kripke_sweep": (lambda: rtg.kripke_sweep(nprocs=6, iters=3),
                     "sweep_cells()"),
    "tortuga": (lambda: rtg.tortuga(nprocs=8, iters=6), "time-loop"),
    "loimos": (lambda: rtg.loimos(nprocs=32, iters=3, hot_procs=(3, 7)),
               "ComputeInteractions()"),
    "axonn_v0": (lambda: rtg.axonn_training(nprocs=4, iters=3, version=0),
                 "forward"),
    "axonn_v2": (lambda: rtg.axonn_training(nprocs=4, iters=3, version=2),
                 "forward"),
    "big_trace": (None, "iteration"),
}

#: the host op calls held exact against the reference
CALLS = [
    ("idle_time", {}),
    ("idle_time", {"k": 3}),
    ("idle_time", {"idle_functions": ["MPI_Wait", "Idle", "MPI_Recv",
                                      "ncclAllReduce", "MPI_Send"]}),
    ("comm_by_process", {}),
    ("comm_by_process", {"output": "count"}),
    ("comm_over_time", {"num_bins": 16}),
    ("comm_over_time", {"output": "count"}),
    ("comm_comp_breakdown", {}),
    ("comm_comp_breakdown", {"comm_matcher": lambda n: n.startswith("MPI")}),
    ("logical_steps", {}),
    ("calculate_lateness", {}),
    ("lateness_by_process", {}),
    ("critical_path_analysis", {}),
    ("activity_series", {"num_bins": 64}),
    ("activity_series", {"num_bins": 64, "process": 1}),
    ("detect_pattern", {"num_bins": 128}),
    ("detect_pattern", {"start_event": None}),   # the generator's name
]
CALL_IDS = [f"{op}-{i}" for i, (op, _) in enumerate(CALLS)]


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """name -> (reference trace, port trace on the CPU) of the same
    events."""
    out = {}
    for name, (make, _start) in GENERATORS.items():
        if make is None:
            d = tmp_path_factory.mktemp("big")
            paths = rtg.big_trace(str(d), nprocs=4, events_per_proc=1500,
                                  calls_per_iter=40, seed=3)
            ref = RefTrace.open(paths)
        else:
            ref = make()
        port = to_port(ref)
        port.label = ref.label
        out[name] = (ref, port)
    return out


def assert_same(got, want, context=""):
    """Exact equality of op results: frames column for column in the same
    order (dtypes too, strings by value), arrays, tuples and lists."""
    if isinstance(want, (list, tuple)):
        assert type(got) is type(want), context
        assert len(got) == len(want), f"{context}: {len(got)} != {len(want)}"
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{context}[{i}]")
        return
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), context
        assert got.dtype == want.dtype, context
        np.testing.assert_array_equal(got, want, err_msg=context)
        return
    assert list(got.columns) == list(want.columns), context
    assert len(got) == len(want), context
    for c in want.columns:
        g, w = np.asarray(got[c]), np.asarray(want[c])
        if w.dtype.kind in "OUS":
            assert [str(x) for x in g] == [str(x) for x in w], \
                f"{context}: column {c}"
        else:
            assert g.dtype == w.dtype, f"{context}: column {c} dtype"
            np.testing.assert_array_equal(g, w,
                                          err_msg=f"{context}: column {c}")


def _kw(name, op, kw):
    if op == "detect_pattern" and "start_event" in kw:
        return {"start_event": GENERATORS[name][1]}
    return kw


@pytest.mark.parametrize("op,kw", CALLS, ids=CALL_IDS)
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_host_ops_equal_the_reference(pairs, name, op, kw):
    ref, port = pairs[name]
    kw = _kw(name, op, kw)
    want = ref.query().run(op, **kw)
    got = port.query().run(op, **kw)
    assert_same(got, want, f"{name} {op} {kw}")


@pytest.mark.parametrize("name", ["tortuga", "gol", "axonn_v2"])
def test_trace_methods_are_the_registered_ops(pairs, name):
    """Each ``Trace`` method runs its registered op, its kernels (none)
    on the trace's device."""
    ref, port = pairs[name]
    start = GENERATORS[name][1]
    for got, want in (
            (port.idle_time(k=2), ref.idle_time(k=2)),
            (port.comm_by_process(), ref.comm_by_process()),
            (port.comm_over_time(num_bins=8), ref.comm_over_time(num_bins=8)),
            (port.comm_comp_breakdown(), ref.comm_comp_breakdown()),
            (port.detect_pattern(start_event=start),
             ref.detect_pattern(start_event=start)),
            (port.calculate_lateness(), ref.calculate_lateness()),
            (port.lateness_by_process(), ref.lateness_by_process()),
            (port.critical_path_analysis(), ref.critical_path_analysis())):
        assert_same(got, want, name)


def test_paper_entry_points_derive_the_structure():
    t = to_port(rtg.gol(nprocs=2, iters=2))
    assert not t._structured
    t._match_caller_callee()
    assert t._structured
    for fn in ("calc_inc_metrics", "calc_exc_metrics"):
        u = to_port(rtg.gol(nprocs=2, iters=2))
        getattr(u, fn)()
        assert u._structured
    assert t._create_cct() is t.cct


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")


@pytest.mark.parametrize("op,kw", CALLS[::2], ids=CALL_IDS[::2])
def test_host_ops_refuse_the_card_without_one(no_card, pairs, op, kw):
    """A host op asked for the card on a machine without one raises, as
    every port entry point does; it does not carry on on the CPU."""
    _ref, port = pairs["gol"]
    with pytest.raises(RuntimeError, match="CUDA"):
        port.run(op, device="cuda", **_kw("gol", op, kw))


def test_generators_and_multirun_refuse_the_card_without_one(no_card, pairs):
    with pytest.raises(RuntimeError, match="CUDA"):
        tg.gol(nprocs=2, iters=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trace.multirun_analysis([pairs["gol"][1]], device="cuda")


# ---------------------------------------------------------------------------
# multirun_analysis: seg_sum per run, within the gate of the reference
# ---------------------------------------------------------------------------

MULTIRUN = {
    "tortuga-scaling": lambda: [rtg.tortuga(nprocs=n, iters=6)
                                for n in (4, 8, 16, 32)],
    "gol-seeds": lambda: [rtg.gol(nprocs=4, iters=3, seed=s)
                          for s in range(3)],
    "axonn-versions": lambda: [rtg.axonn_training(nprocs=4, iters=2,
                                                  version=v)
                               for v in (0, 1, 2)],
    "regression-pair": lambda: list(rtg.regression_pair(
        "tortuga", "computeRhs", nprocs=4, iters=3)),
    "fig1": lambda: [fig1_trace(2), fig1_trace(3)],
}


def _ported(refs):
    out = []
    for r in refs:
        p = to_port(r)
        p.label = r.label
        out.append(p)
    return out


@pytest.mark.parametrize("top_n", [16, 3])
@pytest.mark.parametrize("name", sorted(MULTIRUN))
def test_multirun_within_gate_of_the_reference(name, top_n):
    refs = MULTIRUN[name]()
    want = RefTrace.multirun_analysis(refs, top_n=top_n)
    got = Trace.multirun_analysis(_ported(refs), top_n=top_n)
    assert list(got.columns) == list(want.columns)
    assert [str(x) for x in got["Run"]] == [str(x) for x in want["Run"]]
    for c in list(want.columns)[1:]:
        gate(np.asarray(got[c]), np.asarray(want[c]))


def test_multirun_device_none_runs_each_member_on_its_own_device():
    """``device=None`` reduces each run on its own device (the CPU here),
    through the per-(metric, device) profile cache: a second call reuses
    the profiles and gives the same bits."""
    from repro_torch.kernels import seg_sum
    runs = _ported(MULTIRUN["tortuga-scaling"]())
    n0 = seg_sum.LAUNCHES
    a = Trace.multirun_analysis(runs)
    b = Trace.multirun_analysis(runs, device="cpu")
    assert seg_sum.LAUNCHES == n0          # the plain versions launch none
    for c in a.columns[1:]:
        np.testing.assert_array_equal(np.asarray(a[c]), np.asarray(b[c]))


def test_multirun_reuses_the_profiles_a_set_op_cached(monkeypatch):
    """A set op leaves each member's (metric, device) profile in the
    comparison's cache; ``multirun_analysis`` over the same members (the
    set's relabelled members, as ``chip_smoke.py`` passes them) then
    computes none (on the card: no ``seg_sum`` launch)."""
    from repro_torch.core import ops_summary
    ts = TraceSet(_ported(MULTIRUN["gol-seeds"]()), labels=["a", "b", "c"])
    ts.regression_report()
    runs = list(ts)            # the set's members, under their labels
    calls = []
    real = ops_summary.flat_profile
    monkeypatch.setattr(ops_summary, "flat_profile",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    Trace.multirun_analysis(runs)
    assert calls == []
    Trace.multirun_analysis(runs, metric="time.inc")   # another metric
    assert len(calls) == len(runs)


def _near_tie_runs():
    """Two identical runs in which ``a`` (three calls of 2^24 + 1 ns) beats
    ``b`` (one call of 50,331,650.5 ns) by half a nanosecond in f64, and
    loses in f32, where each ``a`` call rounds to 2^24 and ``b`` up to
    50,331,652."""
    runs = []
    for i in range(2):
        tb = RefBuilder()
        t = 0.0
        for _ in range(3):
            t = tb.call(t, 16_777_217.0, "a", 0)
        tb.call(t, 50_331_650.5, "b", 0)
        runs.append(tb.trace(label=f"run{i}"))
    return runs


def test_multirun_near_tie_reorders_columns_within_the_gate():
    """ROADMAP §C's f32 near-tie: the port orders columns by its own f32
    totals, so two functions whose f64 totals differ by less than the f32
    rounding can swap; the labels, the column set and every value stay
    within the gate."""
    refs = _near_tie_runs()
    want = RefTrace.multirun_analysis(refs)
    got = Trace.multirun_analysis(_ported(refs))
    assert list(want.columns) == ["Run", "a", "b"]
    assert list(got.columns) == ["Run", "b", "a"]
    assert [str(x) for x in got["Run"]] == [str(x) for x in want["Run"]]
    for c in ("a", "b"):
        gate(np.asarray(got[c]), np.asarray(want[c]))
    assert float(got["b"][0]) > float(got["a"][0])


# ---------------------------------------------------------------------------
# the paper's claims (tests/test_ops.py) on the port's own generators
# ---------------------------------------------------------------------------

def test_loimos_load_imbalance_finds_hot_procs():
    t = tg.loimos(nprocs=64, iters=3, hot_procs=(21, 22, 23), device="cpu")
    li = t.load_imbalance(num_processes=3)
    row = {n: i for i, n in enumerate(li[NAME])}
    idx = row["ComputeInteractions()"]
    assert set(int(p) for p in li["Top processes"][idx]) <= {21, 22, 23}
    assert li["time.exc.imbalance"][idx] > 1.5


def test_comm_matrix_symmetric_neighbors():
    t = tg.stencil3d(nprocs=27, iters=2, device="cpu")
    cm = t.comm_matrix()
    assert np.allclose(cm, cm.T)
    assert cm.diagonal().sum() == 0
    counts, _edges = t.message_histogram(bins=10)
    assert (counts > 0).sum() >= 2


def test_comm_over_time_bursty():
    t = tg.gol(nprocs=4, iters=6, device="cpu")
    vals, edges = t.comm_over_time(num_bins=16)
    assert vals.sum() > 0 and len(vals) == 16 and len(edges) == 17


def test_idle_time_ranking():
    t = tg.loimos(nprocs=16, iters=3, hot_procs=(3,), device="cpu")
    procs = t.idle_time(k=16)[PROC].tolist()
    assert int(procs[-1]) == 3          # the hot rank idles least


def test_loimos_hot_ranks_idle_least():
    t = tg.loimos(device="cpu")
    procs = [int(p) for p in t.idle_time()[PROC]]
    assert set(procs[-5:]) == {21, 22, 23, 24, 29}


def test_kripke_critical_path_crosses_processes():
    t = tg.kripke_sweep(nprocs=8, iters=2, device="cpu")
    cp = t.critical_path_analysis()[0]
    assert len(set(cp[PROC].tolist())) >= 4


def test_gol_lateness_positive_for_laggard():
    t = tg.gol(nprocs=4, iters=5, imbalance=0.5, device="cpu")
    assert np.asarray(t.lateness_by_process()["max_lateness"]).max() > 0


def test_tortuga_pattern_detection_counts_iterations():
    t = tg.tortuga(nprocs=8, iters=6, device="cpu")
    assert len(t.detect_pattern(start_event="time-loop")) == 6


def test_axonn_overlap_ordering():
    bd = {v: tg.axonn_training(nprocs=4, iters=4, version=v,
                               device="cpu").comm_comp_breakdown()
          for v in (0, 1, 2)}
    ov = {v: np.asarray(b["overlap"]).mean() for v, b in bd.items()}
    comm = {v: np.asarray(b["comm_only"]).mean() for v, b in bd.items()}
    assert ov[2] > ov[0]
    assert comm[1] < comm[0] and comm[2] < comm[0]


def test_breakdown_parts_add_up_to_the_span():
    for v in (0, 2):
        b = tg.axonn_training(nprocs=4, iters=2, version=v,
                              device="cpu").comm_comp_breakdown()
        parts = sum(np.asarray(b[c]) for c in
                    ("comp_only", "overlap", "comm_only", "other"))
        np.testing.assert_allclose(parts, np.asarray(b["span"]), rtol=1e-12)


def test_multirun_scaling_study():
    traces = [tg.tortuga(nprocs=n, iters=3, device="cpu") for n in (4, 8, 16)]
    df = Trace.multirun_analysis(traces, top_n=6)
    assert "computeRhs" in list(df.columns)
    assert [str(x) for x in df["Run"]] == ["tortuga_4", "tortuga_8",
                                           "tortuga_16"]


# ---------------------------------------------------------------------------
# the interval algebra under comm_comp_breakdown
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interval_algebra_equals_the_reference(seed):
    from repro.core import intervals as ref
    from repro_torch.core import intervals
    rng = np.random.default_rng(seed)
    a0 = rng.uniform(0, 100, 40)
    a = (a0, a0 + rng.uniform(0, 9, 40))
    b0 = rng.uniform(0, 100, 25)
    b = (b0, b0 + rng.uniform(0, 9, 25))
    for got, want in zip(intervals.merge_intervals(*a),
                         ref.merge_intervals(*a)):
        np.testing.assert_array_equal(got, want)
    ma, mb = intervals.merge_intervals(*a), intervals.merge_intervals(*b)
    assert intervals.total_length(*a) == ref.total_length(*a)
    assert intervals.intersect_length(ma, mb) == \
        ref.intersect_length(ma, mb)
    assert intervals.subtract_length(ma, mb) == ref.subtract_length(ma, mb)
    empty = intervals.merge_intervals(np.zeros(0), np.zeros(0))
    assert [len(x) for x in empty] == [0, 0]
