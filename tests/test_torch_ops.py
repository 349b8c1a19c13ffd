"""The port's main path as a whole against the reference.

One trace goes through ``repro`` (``backend="numpy"``, the exact
reference, and ``backend="pallas"``, the TPU kernels in interpret mode)
and through ``repro_torch`` on the CPU (by way of
``convert.events_from_columns``), and the five kernel-backed ops must
agree: rtol 1e-5, atol 1e-3 on sums (f32 kernel accumulation, the
tolerance of ``tests/test_backends.py::assert_equivalent``); counts, bin
edges and histogram counts exact.

On traces whose per-rank totals lie within f32 rounding of each other
(``NEAR_TIES``) the port keeps the ``pallas`` backend's row order and
tolerance, and against ``numpy`` it holds the ``bench_backends.py`` gate
(rtol 1e-4 plus 1e-6 x the largest magnitude), rows that tie within the
gate compared as a multiset.
"""

import numpy as np
import pytest

from repro import tracegen as tg
from repro.core.constants import (DERIVED_COLUMNS, ENTER, ET, EXC, INC,
                                  NAME, PROC)
from repro.core.frame import Categorical as RefCategorical
from repro.core.trace import Trace as RefTrace
from repro.tracegen.builder import TraceBuilder
from repro_torch import Trace, convert
from repro_torch.core import ops_comm, ops_summary, plancache

OPS = [
    ("flat_profile", {"metrics": (EXC, INC)}),
    ("flat_profile", {"per_process": True}),
    ("time_profile", {"num_bins": 8}),
    ("load_imbalance", {}),
    ("comm_matrix", {}),
    ("message_histogram", {"bins": 8}),
]


@pytest.fixture(autouse=True)
def fresh_plan_cache():
    """Each test starts and ends with an empty plan cache of the port, so
    that no test's check is answered by another test's stored result.  A
    test file that runs streaming, pack, scan, live or served ops imports
    this fixture, which makes it autouse there too."""
    plancache.clear()
    yield
    plancache.clear()


def to_port(ref_trace) -> Trace:
    """The reference trace's events (derived columns stripped) as a port
    Trace on the CPU, carried across as NumPy arrays."""
    ev = ref_trace.events.drop(*DERIVED_COLUMNS)
    cats = [c for c in ev.columns
            if isinstance(ev.column(c), RefCategorical)]
    columns = {c: np.asarray(ev.column(c).codes if c in cats
                             else ev.column(c)) for c in ev.columns}
    categories = {c: list(ev.column(c).categories) for c in cats}
    return Trace.from_events(convert.events_from_columns(columns, categories),
                             device="cpu")


def assert_equivalent(op, a, b, context=""):
    """Port result vs reference: f32 rounding on sums, exact counts /
    edges, exact everything non-float."""
    if op == "comm_matrix":
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-3, err_msg=context)
        return
    if op == "message_histogram":
        np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]),
                                      err_msg=f"{context}: counts")
        np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]),
                                      err_msg=f"{context}: edges")
        return
    assert list(a.columns) == list(b.columns), context
    assert len(a) == len(b), context
    for c in a.columns:
        va, vb = np.asarray(a[c]), np.asarray(b[c])
        if va.dtype.kind == "f":
            np.testing.assert_allclose(va, vb, rtol=1e-5, atol=1e-3,
                                       err_msg=f"{context}: column {c}")
        elif va.dtype == object:
            for x, y in zip(va, vb):
                assert np.array_equal(np.asarray(x), np.asarray(y)), \
                    f"{context}: column {c}"
        else:
            np.testing.assert_array_equal(va, vb,
                                          err_msg=f"{context}: column {c}")


def _edge_trace():
    """``tests/test_backends.py``'s edge trace: zero-duration calls, 7
    names, sends, 483 calls (not a multiple of any block size)."""
    tb = TraceBuilder()
    for p in range(3):
        t = float(p) * 0.1
        for i in range(161):
            dur = 0.0 if i % 7 == 0 else (0.5 + ((i + 3 * p) % 5) * 0.25
                                          + p * 0.01)
            t = tb.call(t, dur, f"f{i % 7}", p)
        t = tb.send(t, 1.0, p, (p + 1) % 3, 64.0 * (p + 1))
        tb.recv(t, 1.0, p, (p - 1) % 3, 64.0 * ((p - 1) % 3 + 1))
    return tb.trace()


def _straddle_trace():
    """``tests/test_backends.py``'s straddling-bins trace."""
    tb = TraceBuilder()
    tb.call(0.0, 9.0, "whole", 0)
    t = tb.call(1.4, 2.2, "straddle", 1)
    tb.call(t + 0.1, 5.0, "straddle", 1)
    tb.call(8.999, 0.001, "tail", 2)
    return tb.trace()


def _big_trace(tmp_path_factory):
    d = tmp_path_factory.mktemp("big")
    paths = tg.big_trace(str(d), nprocs=4, events_per_proc=1500,
                         calls_per_iter=40, seed=3)
    return RefTrace.open(paths)


TRACES = {
    "gol": lambda _f: tg.gol(nprocs=4, iters=3),
    "tortuga": lambda _f: tg.tortuga(nprocs=4, iters=2),
    "big_trace": _big_trace,
    "edge": lambda _f: _edge_trace(),
    "straddle": lambda _f: _straddle_trace(),
}


@pytest.fixture(scope="module", params=sorted(TRACES))
def pair(request, tmp_path_factory):
    ref = TRACES[request.param](tmp_path_factory)
    return request.param, ref, to_port(ref)


@pytest.mark.parametrize("op,kw", OPS,
                         ids=[f"{op}-{i}" for i, (op, _) in enumerate(OPS)])
def test_port_matches_numpy_and_pallas(pair, op, kw):
    name, ref, port = pair
    got = port.run(op, **kw)
    for backend in ("numpy", "pallas"):
        want = ref.query().run(op, cache=False, backend=backend, **kw)
        assert_equivalent(op, got, want, context=f"{name}/{op}/{backend}")


def test_single_instant_trace_gives_finite_profile():
    tb = TraceBuilder()
    tb.enter(5.0, "f", 0)
    tb.leave(5.0, "f", 0)
    prof = to_port(tb.trace()).time_profile(num_bins=4)
    for c in prof.columns:
        assert np.isfinite(np.asarray(prof[c], float)).all(), c


def test_empty_trace_ops():
    tb = TraceBuilder()
    tb.call(0.0, 1.0, "f", 0)
    ref = tb.trace()
    port = to_port(ref)
    counts, edges = port.message_histogram(bins=4)
    assert counts.tolist() == [0, 0, 0, 0] and len(edges) == 5
    assert port.comm_matrix().shape == (1, 1)


def test_out_of_range_partner_raises_like_reference():
    tb = TraceBuilder()
    tb.send(0.0, 1.0, 0, 7, 64.0)
    tb.recv(0.5, 1.0, 1, 0, 64.0)
    ref = tb.trace()
    with pytest.raises(IndexError):
        ref.comm_matrix(backend="pallas")
    with pytest.raises(IndexError):
        to_port(ref).comm_matrix()


def test_module_level_ops_take_device():
    port = to_port(tg.gol(nprocs=2, iters=2))
    port._ensure_structure()
    port._ensure_messages()
    a = ops_summary.flat_profile(port, device="cpu")
    b = port.flat_profile()
    assert_equivalent("flat_profile", a, b)
    np.testing.assert_array_equal(ops_comm.comm_matrix(port, device="cpu"),
                                  port.comm_matrix())


# ---------------------------------------------------------------------------
# near-ties: ranks whose totals lie within f32 rounding of each other
# ---------------------------------------------------------------------------

NEAR_TIES = {
    "amg_vcycle": lambda: tg.amg_vcycle(8, 2),
    "kripke_sweep": lambda: tg.kripke_sweep(8, 2),
    "loimos": lambda: tg.loimos(16, 2),
    "axonn_training": lambda: tg.axonn_training(4, 2),
}


@pytest.fixture(scope="module", params=sorted(NEAR_TIES))
def near_tie(request):
    ref = NEAR_TIES[request.param]()
    return request.param, ref, to_port(ref)


def _gate(got, want, scale, context):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=1e-4,
                               atol=1e-6 * scale, err_msg=context)


def _descending_within_gate(values, scale, context):
    """``values`` (the reference's, in the port's row order) never rise by
    more than the gate: rows swap only where the reference ties within
    it."""
    v = np.asarray(values, np.float64)
    rise = v[1:] - v[:-1]
    tol = 1e-4 * np.abs(v[:-1]) + 1e-6 * scale
    assert np.all(rise <= tol), f"{context}: order not descending"


def _rank_totals(ref, metric):
    """(name, process) -> the reference's exact f64 total of ``metric``
    over matched calls: what ``Top processes`` ranks."""
    ref._ensure_structure()
    ev = ref.events
    sel = np.nonzero(ev.cat(ET).mask_eq(ENTER)
                     & (np.asarray(ev.column("_matching_event")) >= 0))[0]
    out = {}
    for n, p, v in zip(ev[NAME][sel], np.asarray(ev[PROC])[sel],
                       np.nan_to_num(np.asarray(ev.column(metric),
                                                np.float64)[sel])):
        out[(str(n), int(p))] = out.get((str(n), int(p)), 0.0) + float(v)
    return out


def assert_within_gate(op, got, want, ref, kw, context=""):
    """Port result vs the exact ``numpy`` reference under the
    ``bench_backends.py`` gate; counts, edges and keys exact; a row order
    that differs only among rows the gate cannot tell apart."""
    if op == "comm_matrix":
        _gate(got, want, max(float(np.abs(want).max()), 1.0), context)
        return
    if op == "message_histogram":
        assert_equivalent(op, got, want, context)
        return
    assert sorted(got.columns) == sorted(want.columns), context
    assert len(got) == len(want), context
    floats = [c for c in want.columns
              if np.asarray(want[c]).dtype.kind == "f"]
    scale = max([1.0] + [float(np.abs(np.asarray(want[c])).max())
                         for c in floats if len(want)])
    if op == "time_profile":
        for c in want.columns:
            _gate(got[c], want[c], scale, f"{context}: column {c}")
        _descending_within_gate(
            [np.sum(want[c]) for c in got.columns[2:]],
            scale * len(want), f"{context}: function columns")
        return
    keys = [c for c in (NAME, PROC) if c in want.columns]
    gk = list(zip(*(np.asarray(got[c]).tolist() for c in keys)))
    wk = list(zip(*(np.asarray(want[c]).tolist() for c in keys)))
    assert sorted(gk) == sorted(wk), f"{context}: row keys"
    row = {k: i for i, k in enumerate(wk)}
    perm = np.asarray([row[k] for k in gk], np.int64)
    for c in want.columns:
        if c in keys or c == "Top processes":
            continue
        a, b = np.asarray(got[c]), np.asarray(want[c])[perm]
        if c in floats:
            _gate(a, b, scale, f"{context}: column {c}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{context}: {c}")
    first = (kw.get("metrics", (EXC,))[0] if op == "flat_profile"
             else f"{EXC}.mean")
    _descending_within_gate(np.asarray(want[first])[perm], scale, context)
    if op == "load_imbalance":
        tot = _rank_totals(ref, EXC)
        for i, name in enumerate(got[NAME]):
            mine = [tot[str(name), int(p)] for p in got["Top processes"][i]]
            theirs = [tot[str(name), int(p)]
                      for p in want["Top processes"][perm[i]]]
            _gate(mine, theirs, scale, f"{context}: top processes {name}")


@pytest.mark.parametrize("op,kw", OPS,
                         ids=[f"{op}-{i}" for i, (op, _) in enumerate(OPS)])
def test_near_ties_keep_pallas_order(near_tie, op, kw):
    name, ref, port = near_tie
    want = ref.query().run(op, cache=False, backend="pallas", **kw)
    assert_equivalent(op, port.run(op, **kw), want,
                      context=f"{name}/{op}/pallas")


@pytest.mark.parametrize("op,kw", OPS,
                         ids=[f"{op}-{i}" for i, (op, _) in enumerate(OPS)])
def test_near_ties_within_gate_of_numpy(near_tie, op, kw):
    name, ref, port = near_tie
    want = ref.query().run(op, cache=False, backend="numpy", **kw)
    assert_within_gate(op, port.run(op, **kw), want, ref, kw,
                       context=f"{name}/{op}/numpy")
