"""``TraceSet``, ``SetQuery`` and the five set-scoped comparison ops of the
port against :mod:`repro.core.diff`.

The same traces (``repro.tracegen``: ``regression_pair``, ``tortuga`` at
several process counts, ``gol`` at two imbalances) go through ``repro``
(its default ``numpy`` backend, exact) and, carried across as NumPy
arrays, through ``repro_torch`` on the CPU, where the kernels' plain
versions run.  Rows are keyed by ``Name`` (or by ``Run`` / ``bin``).  Sums
hold the ``benchmarks/bench_backends.py`` gate: rtol 1e-4 plus 1e-6 x the
largest magnitude.  A delta of two member sums holds the gate of what it
subtracts: each member is within rtol 1e-4 plus 1e-6 x S of the reference,
S the largest magnitude of the members, so their difference is within
2 x (1e-4 + 1e-6) x S.  Exact: ``Run``, ``num_processes``, ``duration``,
``<metric>.total``, ``bin`` / ``bin_frac`` and ``regression_report``'s
``status``.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro import tracegen as tg
from repro.core import TraceSet as RefSet
from repro.core.constants import EXC, INC, NAME
from repro_torch import Trace, TraceSet
from repro_torch.core import Filter, diff, ops_summary, registry, structure
from repro_torch.core.diff import (SetQuery, align_flat_profiles,
                                   regression_report, run_labels)
from repro_torch.launch.cardcheck import digest
from repro_torch.readers import write_jsonl
from repro_torch.tracegen import big_trace

from test_torch_ops import fresh_plan_cache  # noqa: F401
from test_torch_ops import to_port

SET_OPS = ["diff_flat_profile", "diff_time_profile", "scaling_analysis",
           "diff_load_imbalance", "regression_report"]
EXACT = {"Run", "num_processes", "duration", "bin", "bin_frac", "status",
         f"{EXC}.total", f"{INC}.total"}
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


def _pair(app, func, factor, **kw):
    return lambda: tg.regression_pair(app, func=func, factor=factor, **kw)


#: name -> a builder of the reference traces the set compares
SETS = {
    "tortuga-regressed": _pair("tortuga", "computeRhs", 1.6, nprocs=4,
                               iters=3),
    "gol-improved": _pair("gol", "compute_cells()", 0.5, nprocs=4, iters=3),
    "tortuga-scaling": lambda: [tg.tortuga(nprocs=n, iters=2)
                                for n in (4, 8, 16)],
    "gol-skew": lambda: [tg.gol(nprocs=8, iters=3, imbalance=0.05),
                         tg.gol(nprocs=8, iters=3, imbalance=0.8)],
}

#: (op, kwargs) cases: every mode, baseline / target (negative indices
#: too), top_n
CASES = [
    ("diff_flat_profile", {}),
    ("diff_flat_profile", {"mode": "relative"}),
    ("diff_flat_profile", {"mode": "normalized", "baseline": -1}),
    ("diff_flat_profile", {"metric": INC, "top_n": 3}),
    ("diff_time_profile", {"num_bins": 16}),
    ("diff_time_profile", {"num_bins": 8, "normalized": True,
                           "baseline": -1, "target": 0}),
    ("scaling_analysis", {}),
    ("scaling_analysis", {"mode": "weak", "top_n": None}),
    ("scaling_analysis", {"metric": INC, "top_n": 1}),
    ("diff_load_imbalance", {}),
    ("diff_load_imbalance", {"baseline": -1, "target": 0}),
    ("regression_report", {}),
    ("regression_report", {"threshold": 0.2, "top_n": 3}),
    ("regression_report", {"metric": INC, "baseline": 1, "target": -2}),
]


@pytest.fixture(scope="module", params=sorted(SETS))
def sets(request):
    refs = list(SETS[request.param]())
    labels = [f"r{i}" for i in range(len(refs))]
    ports = [to_port(t) for t in refs]
    return request.param, refs, ports, labels


def _scale(values) -> float:
    v = np.asarray(values, np.float64)
    v = v[np.isfinite(v)]
    return float(np.abs(v).max()) if len(v) else 0.0


def _member_scale(op, refs, kw) -> float:
    """The largest magnitude the op's member results hold: a delta's
    absolute error is bounded by the f32 rounding of what it subtracts."""
    metric = kw.get("metric", EXC)
    if op == "diff_time_profile":
        num_bins = kw.get("num_bins", 32)
        profs = [t.query().run("time_profile", num_bins=num_bins,
                               metric=metric, cache=False,
                               normalized=kw.get("normalized", False))
                 for t in refs]
        return max(_scale(p[c]) for p in profs for c in p.columns
                   if c not in ("bin_start", "bin_end"))
    if op == "diff_load_imbalance":
        return 1.0
    prof = [t.query().run("flat_profile", metrics=[metric], cache=False)
            for t in refs]
    return max(_scale(p[metric]) for p in prof)


def _rows(frame, op):
    """Row keys of a set-op result."""
    if NAME in frame.columns:
        return [str(x) for x in frame[NAME]]
    if "Run" in frame.columns:
        return [str(x) for x in frame["Run"]]
    return [int(x) for x in frame["bin"]]


def assert_set_result(op, got, want, refs, kw, context=""):
    """Same columns and rows (keyed), exact where the values are exact,
    the gate on sums, a delta held to the gate of what it subtracts."""
    assert sorted(got.columns) == sorted(want.columns), context
    kg, kw_ = _rows(got, op), _rows(want, op)
    assert sorted(kg) == sorted(kw_), f"{context}: rows {kg} vs {kw_}"
    at = {k: i for i, k in enumerate(kg)}
    perm = np.asarray([at[k] for k in kw_], np.int64)
    member = _member_scale(op, refs, kw)
    relative = op == "diff_flat_profile" and kw.get("mode") == "relative"
    for c in want.columns:
        a = np.asarray(got[c])[perm]
        b = np.asarray(want[c])
        if c in EXACT or b.dtype.kind not in "f":
            assert np.array_equal(a.astype(b.dtype), b), \
                f"{context}: column {c}"
            continue
        atol = 1e-6 * max(_scale(b), 1.0)
        is_delta = (c.startswith("delta") or op == "diff_time_profile")
        if is_delta and c != "delta_rel" and not relative:
            # the gate of the two member sums it subtracts
            atol = max(atol, 2 * (1e-4 + 1e-6) * member)
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b),
                                      err_msg=f"{context}: column {c}")
        fin = np.isfinite(b)
        np.testing.assert_array_equal(a[~fin], b[~fin],
                                      err_msg=f"{context}: column {c}")
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-4, atol=atol,
                                   err_msg=f"{context}: column {c}")


@pytest.mark.parametrize("op,kw", CASES,
                         ids=[f"{op}-{i}" for i, (op, _) in enumerate(CASES)])
def test_set_ops_match_reference(sets, op, kw):
    name, refs, ports, labels = sets
    want = RefSet(refs, labels=labels).run(op, **kw)
    got = TraceSet(ports, labels=labels).run(op, **kw)
    assert_set_result(op, got, want, refs, kw, f"{name}/{op}/{kw}")


@pytest.mark.parametrize("name,func", [
    ("tortuga-regressed", "computeRhs"),
    ("gol-improved", "compute_cells()")])
def test_regression_status_and_top_row_exact(name, func):
    refs = list(SETS[name]())
    want = RefSet(refs).regression_report()
    got = TraceSet([to_port(t) for t in refs]).regression_report()
    assert str(got[NAME][0]) == str(want[NAME][0])
    byname = dict(zip(map(str, got[NAME]), got["status"]))
    assert byname == dict(zip(map(str, want[NAME]), want["status"]))
    assert byname[func] in ("regressed", "improved")


def test_set_result_columns_are_the_members_own_ops():
    """A member's column in a comparison is that member's own op result,
    bit for bit: its flat profile, its load imbalance."""
    refs = SETS["tortuga-regressed"]()
    a, b = (to_port(t) for t in refs)
    ts = TraceSet([a, b], labels=["a", "b"])
    d = ts.diff_flat_profile()
    li = ts.diff_load_imbalance()
    for lbl, t in (("a", ts[0]), ("b", ts[1])):
        prof = t.flat_profile()
        own = dict(zip(map(str, prof[NAME]), np.asarray(prof[EXC])))
        col = dict(zip(map(str, d[NAME]), np.asarray(d[f"{EXC}|{lbl}"])))
        assert all(own[k] == v for k, v in col.items() if k in own)
        imb = t.load_imbalance()
        own = dict(zip(map(str, imb[NAME]),
                       np.asarray(imb[f"{EXC}.imbalance"])))
        col = dict(zip(map(str, li[NAME]),
                       np.asarray(li[f"imbalance|{lbl}"])))
        assert all(own[k] == v for k, v in col.items() if k in own)


def test_align_flat_profiles_zero_fills_and_marks_presence():
    a = to_port(tg.tortuga(nprocs=4, iters=2))
    b = a.filter(Filter(NAME, "not-in", ["gradC2C"]))
    labels, names, mat, present = align_flat_profiles([a, b])
    j = names.index("gradC2C")
    assert present[0, j] and not present[1, j]
    assert mat[1, j] == 0.0 and mat[0, j] > 0
    rep = regression_report([a, b])
    assert dict(zip(map(str, rep[NAME]), rep["status"]))["gradC2C"] == \
        "vanished"
    rep2 = regression_report([b, a])
    row = list(map(str, rep2[NAME])).index("gradC2C")
    assert rep2["status"][row] == "new" and np.isinf(rep2["delta_rel"][row])


@pytest.mark.parametrize("mode", ["absolute", "normalized"])
def test_diff_flat_profile_antisymmetric(mode):
    a = to_port(tg.tortuga(nprocs=4, iters=2, seed=0))
    b = to_port(tg.tortuga(nprocs=4, iters=2, seed=1))
    ab = TraceSet([a, b]).diff_flat_profile(mode=mode)
    ba = TraceSet([b, a]).diff_flat_profile(mode=mode)
    assert list(ab[NAME]) == list(ba[NAME])
    da = np.asarray(ab[[c for c in ab.columns if c.startswith("delta|")][0]])
    db = np.asarray(ba[[c for c in ba.columns if c.startswith("delta|")][0]])
    np.testing.assert_array_equal(da, -db)


def test_out_of_range_run_index_is_loud():
    a, b = (to_port(tg.gol(nprocs=2, iters=1, seed=s)) for s in (0, 1))
    with pytest.raises(IndexError):
        regression_report([a, b], baseline=-3)
    with pytest.raises(IndexError):
        regression_report([a, b], target=2)
    with pytest.raises(IndexError):
        TraceSet([a, b]).diff_flat_profile(baseline=5)
    with pytest.raises(ValueError, match="mode"):
        TraceSet([a, b]).scaling_analysis(mode="nope")


# ---------------------------------------------------------------------------
# labels, mapping, refusals
# ---------------------------------------------------------------------------

def test_labels_never_mutate_the_callers_traces():
    a = to_port(tg.gol(nprocs=2, iters=1, seed=0))
    b = to_port(tg.gol(nprocs=2, iters=1, seed=1))
    a.label = "prod-run"
    ts = TraceSet([a, b], labels=["base", "exp"])
    assert ts.labels == ["base", "exp"] and a.label == "prod-run"
    assert ts[0] is not a and ts[0].events is a.events
    assert ts[0].device == a.device
    ts[0]._ensure_structure()           # lands in the shared frame
    assert EXC in a.events
    assert run_labels([a, b]) == ["prod-run", "run1"]
    b.label = "x"
    assert run_labels([a, b, b]) == ["prod-run", "x", "x#2"]
    with pytest.raises(ValueError, match="labels"):
        TraceSet([a, b], labels=["x"])


def test_relabel_of_a_streaming_member(tmp_path):
    p = str(tmp_path / "t.jsonl")
    write_jsonl(to_port(tg.gol(nprocs=2, iters=1)), p)
    st = Trace.open(p, streaming=True, device="cpu")
    ts = TraceSet([st, st], labels=["a", "b"])
    assert [m.label for m in ts] == ["a", "b"] and st.label == p
    assert ts[0].paths == st.paths and ts[0].device == st.device


def test_trace_op_mapped_over_a_set():
    ports = [to_port(tg.gol(nprocs=2, iters=2, seed=s)) for s in range(3)]
    ts = TraceSet(ports)
    hists = ts.message_histogram(bins=4)
    assert isinstance(hists, list) and len(hists) == 3
    for got, t in zip(hists, ports):
        assert digest(got) == digest(t.message_histogram(bins=4))
    profs = ts.query().flat_profile()
    assert [digest(p) for p in profs] == [digest(t.flat_profile())
                                          for t in ports]


def test_set_ops_refused_on_a_single_trace_query():
    t = to_port(tg.gol(nprocs=2, iters=1))
    with pytest.raises(ValueError, match="TraceSet"):
        t.query().run("regression_report")
    with pytest.raises(ValueError, match="TraceSet"):
        t.run("diff_flat_profile")
    with pytest.raises(ValueError, match="at least 2"):
        TraceSet([t]).regression_report()
    with pytest.raises(ValueError):
        TraceSet([])
    with pytest.raises(AttributeError):
        TraceSet([t]).no_such_op()
    with pytest.raises(ValueError, match="scope"):
        registry.register_op("x", scope="galaxy")


def test_set_ops_registered_with_set_scope():
    scoped = {op for op in registry.list_ops()
              if registry.get_op(op).scope == "set"}
    assert scoped == set(SET_OPS)


# ---------------------------------------------------------------------------
# the shared plan
# ---------------------------------------------------------------------------

def test_set_query_prepares_each_member_once(monkeypatch):
    """One plan over three members, two chained comparison ops: structure
    is derived once per member and each member's flat profile is computed
    once (the profile cache), not once per op."""
    ports = [to_port(tg.tortuga(nprocs=4, iters=2, seed=s))
             for s in range(3)]
    calls = []
    real = ops_summary.flat_profile

    def counting(trace, *a, **kw):
        calls.append(trace)
        return real(trace, *a, **kw)

    monkeypatch.setattr(ops_summary, "flat_profile", counting)
    q = (TraceSet(ports).query()
         .filter(Filter(NAME, "not-in", ["MPI_Isend"]))
         .restrict_processes(range(3)))
    derive0 = structure.DERIVE_CALLS
    d = q.diff_flat_profile()
    rep = q.regression_report()
    assert structure.DERIVE_CALLS - derive0 == 3
    assert len(calls) == 3 and len({id(t) for t in calls}) == 3
    assert len([c for c in d.columns if c.startswith("delta|")]) == 2
    assert len(rep) > 0
    for t in q.collect():
        assert set(np.asarray(t.events["Process"]).tolist()) <= {0, 1, 2}
    assert "shared plan" in q.explain()


def test_set_query_matches_the_reference_plan():
    refs = [tg.gol(nprocs=4, iters=3, seed=s) for s in (0, 1)]
    ts_all = np.asarray(refs[0].events["Timestamp (ns)"], np.float64)
    lo, hi = np.percentile(ts_all, 20), np.percentile(ts_all, 80)
    labels = ["a", "b"]
    want = (RefSet(refs, labels=labels).query().slice_time(lo, hi)
            .regression_report())
    got = (TraceSet([to_port(t) for t in refs], labels=labels).query()
           .slice_time(lo, hi).regression_report())
    assert_set_result("regression_report", got, want,
                      [t.slice_time(lo, hi) for t in refs], {}, "slice")


# ---------------------------------------------------------------------------
# devices
# ---------------------------------------------------------------------------

def test_a_cpu_set_never_asks_for_cuda(monkeypatch):
    def no(*_a, **_k):
        raise AssertionError("a CPU set asked for CUDA")

    monkeypatch.setattr(torch.cuda, "is_available", no)
    monkeypatch.setattr(torch.cuda, "is_initialized", no)
    refs = SETS["tortuga-regressed"]()
    ts = TraceSet([to_port(t) for t in refs])
    for op in SET_OPS:
        ts.run(op)
    ts.message_histogram()
    ts.run("regression_report", device="cpu")


def test_a_set_op_asked_for_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine with no card")
    ports = [to_port(tg.gol(nprocs=2, iters=1, seed=s)) for s in (0, 1)]
    with pytest.raises(RuntimeError, match="CUDA"):
        TraceSet(ports).regression_report(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        TraceSet.open(["x.jsonl"])


def test_profile_cache_keeps_devices_apart(monkeypatch):
    """The cache is keyed by (metric, device): an entry stored for the card
    never answers a CPU call, and a repeat on one device is a hit."""
    a, b = (to_port(t) for t in SETS["tortuga-regressed"]())
    calls = []
    real = ops_summary.flat_profile

    def counting(trace, *args, device="cuda", **kw):
        calls.append(str(device))
        return real(trace, *args, device=device, **kw)

    monkeypatch.setattr(ops_summary, "flat_profile", counting)
    ts = TraceSet([a, b])
    first = ts.regression_report()
    assert calls == ["cpu", "cpu"]
    sentinel = object()
    diff._PROFILE_CACHE[a][(EXC, torch.device("cuda"))] = sentinel
    again = ts.regression_report(device="cpu")
    assert calls == ["cpu", "cpu"] and digest(again) == digest(first)
    assert set(diff._PROFILE_CACHE[a]) == {"_n", (EXC, torch.device("cpu")),
                                          (EXC, torch.device("cuda"))}


# ---------------------------------------------------------------------------
# streaming members
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scaled_shards(tmp_path_factory):
    """The same application at 4 and 2 ranks, as per-rank jsonl shards."""
    d = tmp_path_factory.mktemp("scaled")
    return [big_trace(str(d / f"n{n}"), nprocs=n, events_per_proc=900,
                      calls_per_iter=30, seed=n) for n in (4, 2)]


@pytest.mark.parametrize("op,kw", [
    ("regression_report", {}), ("diff_flat_profile", {"mode": "relative"}),
    ("diff_time_profile", {"num_bins": 12}), ("scaling_analysis", {}),
    ("diff_load_imbalance", {})])
def test_streaming_members_give_the_eager_bits(scaled_shards, op, kw):
    labels = ["n4", "n2"]
    eager = TraceSet.open(scaled_shards, labels=labels, device="cpu")
    for rows in (61, 1000):
        st = TraceSet.open(scaled_shards, streaming=True, chunk_rows=rows,
                           labels=labels, device="cpu")
        assert digest(st.run(op, **kw)) == digest(eager.run(op, **kw)), rows


def test_streaming_set_query_binds_the_plan(scaled_shards):
    labels = ["n4", "n2"]
    sel = Filter(NAME, "not-in", ["MpiSend"])
    eager = TraceSet.open(scaled_shards, labels=labels, device="cpu")
    st = TraceSet.open(scaled_shards, streaming=True, chunk_rows=97,
                       labels=labels, device="cpu")
    for op in ("regression_report", "diff_time_profile"):
        assert digest(st.query().filter(sel).run(op)) == \
            digest(eager.query().filter(sel).run(op)), op
    with pytest.raises(ValueError, match="streaming"):
        TraceSet.open(scaled_shards, chunk_rows=10, device="cpu")


# ---------------------------------------------------------------------------
# pooled preparation, from a script on disk (spawn workers re-import it)
# ---------------------------------------------------------------------------

_SCRIPT = """
import sys, warnings
sys.path.insert(0, {src!r})
from repro_torch import Trace, TraceSet
from repro_torch.core import NAME, Filter
from repro_torch.launch.cardcheck import digest


def main():
    warnings.simplefilter("error", RuntimeWarning)  # no degradation
    labels = ["n4", "n2"]
    eager = TraceSet.open({shards!r}, labels=labels, device="cpu")
    q = eager.query().filter(Filter(NAME, "not-in", ["MpiSend"]))
    serial = q.run("regression_report")
    pq = eager.query().filter(Filter(NAME, "not-in", ["MpiSend"]))
    pooled = pq.run("regression_report", processes=2)
    assert digest(pooled) == digest(serial)
    assert len(pq.units_cuda) == 2 and not any(pq.units_cuda), pq.units_cuda
    assert all(str(t.device) == "cpu" for t in pq.collect())
    st = TraceSet.open({shards!r}, streaming=True, chunk_rows=211,
                       processes=2, labels=labels, device="cpu")
    pools = {{id(m._pool) for m in st}}
    assert len(pools) == 1 and st[0]._pool is not None
    for op in ("regression_report", "diff_time_profile", "scaling_analysis"):
        sq = st.query()
        assert digest(sq.run(op)) == digest(eager.run(op)), op
        units = [m.units_cuda for m in sq.collect()]
        assert all(len(u) >= 2 and not any(u) for u in units), units
    st[0]._pool.close()
    print("POOLED", len(pq.units_cuda))


if __name__ == "__main__":
    main()
"""


def test_pooled_prepare_and_streaming_set_from_a_script(scaled_shards,
                                                         tmp_path):
    """A two-worker spawn pool prepares the members of a plan (the serial
    bits, every member back on its device, no worker on CUDA), and a
    streaming set with ``processes=2`` fans every member into one shared
    pool (the eager bits)."""
    script = tmp_path / "run_set_pool.py"
    script.write_text(textwrap.dedent(_SCRIPT.format(
        src=SRC, shards=scaled_shards)))
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("POOLED 2"), out.stdout


def test_pool_prepare_in_process_keeps_devices(monkeypatch):
    """``_pool_prepare`` run serially (the spawn guard refuses a pool under
    pytest's ``__main__``): the members come back on their devices, the
    plan's bits equal the serial plan's, and a cached member's missing
    prerequisites are prepared through it too."""
    ports = [to_port(tg.gol(nprocs=2, iters=2, seed=s)) for s in (0, 1)]
    calls = {"n": 0}
    real = SetQuery._pool_prepare

    def counting(self, *a):
        calls["n"] += 1
        return real(self, *a)

    monkeypatch.setattr(SetQuery, "_pool_prepare", counting)
    q = TraceSet(ports).query().restrict_processes([0, 1])
    q.collect()
    got = q.run("diff_flat_profile", processes=2)
    assert calls["n"] == 1
    want = TraceSet(ports).query().restrict_processes([0, 1]) \
        .diff_flat_profile()
    assert digest(got) == digest(want)
    assert all(t.device == torch.device("cpu") for t in q.collect())
    assert q.units_cuda == [False, False]
