"""The port's filters, lazy query plans and calling context tree against
the reference.

One trace goes through ``repro`` and, carried across as NumPy arrays,
through ``repro_torch`` on the CPU.  Filter masks, collected sub-traces
(every event column, the derived structure columns included, on both the
remap and the recompute route) and calling context trees must be equal;
plan terminals agree with the reference's ``backend="pallas"`` terminals
within ``tests/test_torch_ops.py``'s tolerance.
"""

import numpy as np
import pytest

from repro import tracegen as tg
from repro.core.filters import Filter as RefFilter
from repro.core.filters import time_window_filter as ref_window
from repro_torch import Trace
from repro_torch.core import Filter, TraceQuery, time_window_filter
from repro_torch.core.constants import (DERIVED_COLUMNS, ET, EXC, INC, NAME,
                                        PROC, TS)
from repro_torch.core.query import scan

from test_torch_ops import OPS, assert_equivalent, to_port
from test_torch_stragglers import assert_findings

GENS = {"gol": lambda: tg.gol(nprocs=4, iters=3),
        "tortuga": lambda: tg.tortuga(nprocs=4, iters=2)}


def _both(gen):
    ref = GENS[gen]()
    return ref, to_port(ref)


def _window(ev, lo=30, hi=70):
    ts = np.asarray(ev[TS], np.float64)
    return float(np.percentile(ts, lo)), float(np.percentile(ts, hi))


def _names(ev):
    """(a leaf function, a function with callees) of the trace."""
    depth_of = {}
    for n, d in zip(ev[NAME], np.asarray(ev.column("_depth"))):
        depth_of[n] = max(depth_of.get(n, 0), int(d))
    by_depth = sorted(depth_of, key=lambda n: (depth_of[n], n))
    return by_depth[-1], by_depth[0]


def assert_events_equal(got, want, context=""):
    """Every column of two frames: names in order, dtypes and values
    (NaN where the other has NaN)."""
    assert list(got.columns) == list(want.columns), context
    assert len(got) == len(want), context
    for c in want.columns:
        a, b = np.asarray(got[c]), np.asarray(want[c])
        assert a.dtype == b.dtype, f"{context}: {c} {a.dtype} vs {b.dtype}"
        if a.dtype.kind == "f":
            assert np.array_equal(a, b, equal_nan=True), f"{context}: {c}"
        else:
            assert np.array_equal(a, b), f"{context}: {c}"


# ---------------------------------------------------------------------------
# filters
# ---------------------------------------------------------------------------

def _filters(ev, F, window):
    """(label, filter) cases over one frame, built with ``F`` (either
    package's Filter) and ``window`` (either package's
    time_window_filter)."""
    names = sorted(set(ev[NAME]))
    lo, hi = _window(ev)
    return [
        ("name==", F(NAME, "==", names[0])),
        ("name!=", F(NAME, "!=", names[1])),
        ("name-in", F(NAME, "in", names[:2] + ["no_such_fn"])),
        ("name-not-in", F(NAME, "not-in", [names[-1], "no_such_fn"])),
        ("proc==", F(PROC, "==", 1)),
        ("proc!=", F(PROC, "!=", 1)),
        ("proc<", F(PROC, "<", 2)),
        ("proc<=", F(PROC, "<=", 2)),
        ("proc>", F(PROC, ">", 1.5)),
        ("proc>=", F(PROC, ">=", 3)),
        ("proc-in", F(PROC, "in", [0, 3])),
        ("proc-not-in", F(PROC, "not-in", [1])),
        ("ts-between", F(TS, "between", (lo, hi))),
        ("et==", F(ET, "==", "Enter")),
        ("and", F(NAME, "!=", names[0]) & F(PROC, "<", 3)),
        ("or", F(PROC, "==", 0) | F(NAME, "==", names[1])),
        ("not", ~F(PROC, "in", [1, 2])),
        ("nested", ~(F(PROC, ">=", 2) & F(NAME, "in", names[:2]))
         | F(TS, "between", (lo, hi))),
        ("within", window(lo, hi, trim="within")),
    ]


N_FILTERS = 19


@pytest.mark.parametrize("gen", sorted(GENS))
@pytest.mark.parametrize("case", range(N_FILTERS))
def test_filter_mask_columns_and_bounds_match_reference(gen, case):
    ref, port = _both(gen)
    label, f = _filters(port.events, Filter, time_window_filter)[case]
    rlabel, rf = _filters(ref.events, RefFilter, ref_window)[case]
    assert label == rlabel
    np.testing.assert_array_equal(np.asarray(f.mask(port.events)),
                                  np.asarray(rf.mask(ref.events)),
                                  err_msg=label)
    assert f.columns() == rf.columns(), label
    assert f.process_bounds() == rf.process_bounds(), label
    assert f.trim == rf.trim and f.window() == rf.window(), label
    # the eager selection equals the reference's too
    assert_events_equal(port.filter(f).events, ref.filter(rf).events, label)


@pytest.mark.parametrize("trim", ["overlap", "within"])
@pytest.mark.parametrize("gen", sorted(GENS))
def test_time_window_filter_matches_reference(gen, trim):
    ref, port = _both(gen)
    lo, hi = _window(port.events)
    got = port.filter(time_window_filter(lo, hi, trim=trim))
    want = ref.filter(ref_window(lo, hi, trim=trim))
    assert_events_equal(got.events, want.events, trim)
    assert_events_equal(port.slice_time(lo, hi, trim=trim).events,
                        got.events, trim)


def test_overlap_window_under_or_and_not_raises():
    port = to_port(tg.gol(nprocs=4, iters=3))
    tw = time_window_filter(0, 1e9)
    with pytest.raises(ValueError):
        port.filter(tw | Filter(PROC, "==", 0))
    with pytest.raises(ValueError):
        port.filter(~tw)
    with pytest.raises(ValueError):
        time_window_filter(0, 1, trim="nope")
    with pytest.raises(ValueError):
        Filter(PROC, "~=", 0)


# ---------------------------------------------------------------------------
# collect(): the remap and recompute routes, every event column
# ---------------------------------------------------------------------------

def _plan(q, kind, ev, F, window):
    """One plan of each kind on a query ``q`` (either package's), built
    from the structured frame ``ev``."""
    lo, hi = _window(ev, 20, 80)
    leaf, parent = _names(ev)
    thr = float(np.nanmedian(np.asarray(ev.column(EXC), np.float64)))
    if kind == "procs":
        return q.restrict_processes([0, 2])
    if kind == "overlap":
        return q.slice_time(lo, hi)
    if kind == "within":
        return q.slice_time(lo, hi, trim="within")
    if kind == "drop-leaf":
        return q.filter(F(NAME, "not-in", [leaf]))
    if kind == "drop-parent":
        return q.filter(F(NAME, "!=", parent))
    if kind == "drop-leaves":
        return q.filter(F(ET, "!=", "Leave"))
    if kind == "chain":
        return (q.slice_time(lo, hi).filter(F(NAME, "not-in", [leaf]))
                .restrict_processes(range(3)))
    if kind == "procs-then-window":
        return q.restrict_processes(range(3)).slice_time(lo, hi)
    if kind == "derived":
        return q.slice_time(lo, hi).filter(F(EXC, ">", thr))
    if kind == "window-and":
        return q.filter(window(lo, hi) & F(PROC, "<", 3))
    raise ValueError(kind)


PLANS = ["procs", "overlap", "within", "drop-leaf", "drop-parent",
         "drop-leaves", "chain", "procs-then-window", "derived",
         "window-and"]


@pytest.mark.parametrize("structured", [True, False],
                         ids=["structured-source", "bare-source"])
@pytest.mark.parametrize("kind", PLANS)
@pytest.mark.parametrize("gen", sorted(GENS))
def test_collect_matches_reference_on_every_column(gen, kind, structured):
    ref, port = _both(gen)
    probe = to_port(ref)
    probe._ensure_structure()
    if structured:
        ref._ensure_structure()
        ref._ensure_messages()
        port._ensure_structure()
        port._ensure_messages()
    got = _plan(port.query(), kind, probe.events, Filter,
                time_window_filter).collect()
    want = _plan(ref.query(), kind, probe.events, RefFilter,
                 ref_window).collect()
    assert got.device == port.device
    assert got._structured == want._structured, kind
    assert_events_equal(got.events, want.events, kind)
    if want._msg_match is None:
        assert got._msg_match is None
    else:
        np.testing.assert_array_equal(got._msg_match, want._msg_match)
    got._ensure_structure()
    want._ensure_structure()
    assert_events_equal(got.events, want.events, f"{kind} + structure")


@pytest.mark.parametrize("kind", PLANS)
def test_remap_equals_recompute(kind):
    """Where a plan remapped the source's structure, the derived columns
    equal a from-scratch derivation on the selected rows, bit for bit;
    where it could not, it dropped them for a lazy recompute."""
    port = to_port(tg.tortuga(nprocs=4, iters=2))
    port._ensure_structure()
    sub = _plan(port.query(), kind, port.events, Filter,
                time_window_filter).collect()
    if not sub._structured:
        assert not set(DERIVED_COLUMNS) & set(sub.events.columns), kind
        return
    fresh = Trace(sub.events.drop(*DERIVED_COLUMNS).copy(), device="cpu")
    fresh._ensure_structure()
    for c in DERIVED_COLUMNS[:-1]:
        np.testing.assert_array_equal(np.asarray(sub.events.column(c)),
                                      np.asarray(fresh.events.column(c)),
                                      err_msg=c)


def test_explain_matches_reference():
    ref, port = _both("tortuga")
    probe = to_port(ref)
    probe._ensure_structure()
    for kind in PLANS:
        got = _plan(port.query(), kind, probe.events, Filter,
                    time_window_filter)
        want = _plan(ref.query(), kind, probe.events, RefFilter, ref_window)
        assert got.explain().splitlines()[1:] == \
            want.explain().splitlines()[1:], kind


def test_zero_step_collect_is_identity_and_selection_never_aliases():
    port = to_port(tg.gol(nprocs=2, iters=1))
    assert port.query().collect() is port
    sub = port.query().restrict_processes([0]).collect()
    assert sub is not port and sub.device == port.device
    empty = port.filter(Filter(PROC, "==", 99))
    assert len(empty) == 0 and empty.filter(Filter(PROC, "==", 0)) \
        is not empty


# ---------------------------------------------------------------------------
# the six ops as plan terminals
# ---------------------------------------------------------------------------

TERMINALS = OPS + [("stragglers", {"threshold": -1.0})]


def _terminal_plan(q, ev, F):
    lo, hi = _window(ev, 10, 90)
    leaf, _parent = _names(ev)
    return q.slice_time(lo, hi).filter(F(NAME, "not-in", [leaf]))


@pytest.mark.parametrize("op,kw", TERMINALS,
                         ids=[f"{op}-{i}" for i, (op, _) in
                              enumerate(TERMINALS)])
@pytest.mark.parametrize("gen", sorted(GENS))
def test_plan_terminals_match_reference_pallas(gen, op, kw):
    ref, port = _both(gen)
    probe = to_port(ref)
    probe._ensure_structure()
    got = getattr(_terminal_plan(port.query(), probe.events, Filter), op)(
        **kw)
    want = _terminal_plan(ref.query(), probe.events, RefFilter).run(
        op, cache=False, backend="pallas", **kw)
    if op == "stragglers":
        assert_findings(got, want, f"{gen}/{op}")
    else:
        assert_equivalent(op, got, want, context=f"{gen}/{op}")


@pytest.mark.parametrize("op,kw", TERMINALS,
                         ids=[f"{op}-{i}" for i, (op, _) in
                              enumerate(TERMINALS)])
def test_process_restricted_terminals_match_reference(op, kw):
    """A process subset cuts message partners out of the trace: the comm
    matrix raises there as the reference does; every other op agrees."""
    ref, port = _both("gol")
    plan = port.query().restrict_processes([0, 1])
    rplan = ref.query().restrict_processes([0, 1])
    try:
        want = rplan.run(op, cache=False, backend="pallas", **kw)
    except IndexError:
        with pytest.raises(IndexError):
            plan.run(op, **kw)
        return
    got = plan.run(op, **kw)
    if op == "stragglers":
        assert_findings(got, want, op)
    else:
        assert_equivalent(op, got, want, context=op)


def test_run_and_terminal_dispatch():
    port = to_port(tg.gol(nprocs=2, iters=1))
    q = port.query().restrict_processes([0])
    with pytest.raises(ValueError, match="unknown analysis op"):
        q.run("no_such_op")
    with pytest.raises(AttributeError):
        q.no_such_op
    with pytest.raises(AttributeError):
        q._private
    assert q.flat_profile.__name__ == "flat_profile"
    a = q.flat_profile(device="cpu")
    assert_equivalent("flat_profile", a, q.run("flat_profile"))
    assert_equivalent("flat_profile", q.run("flat_profile", cache=False), a)


# ---------------------------------------------------------------------------
# calling context tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", [INC, EXC])
@pytest.mark.parametrize("gen", sorted(GENS))
def test_cct_matches_reference(gen, metric):
    ref, port = _both(gen)
    got, want = port.cct, ref.cct
    assert port.cct is got
    assert [n.path() for n in got.nodes] == [n.path() for n in want.nodes]
    assert [n.depth for n in got.nodes] == [n.depth for n in want.nodes]
    np.testing.assert_array_equal(got.event_node, want.event_node)
    a = got.aggregate(port.events, metric)
    b = want.aggregate(ref.events, metric)
    assert list(a.columns) == list(b.columns)
    for c in b.columns:
        np.testing.assert_array_equal(np.asarray(a[c]), np.asarray(b[c]))
    node = int(np.asarray(b["node"])[0])
    pa = got.per_process(port.events, node, metric)
    pb = want.per_process(ref.events, node, metric)
    for c in pb.columns:
        np.testing.assert_array_equal(np.asarray(pa[c]), np.asarray(pb[c]))
    assert got.render(port.events, metric) == want.render(ref.events, metric)


def test_cct_node_column_is_dropped_by_selection():
    port = to_port(tg.gol(nprocs=4, iters=2))
    port.cct
    assert "_cct_node" in port.events
    sub = port.filter_processes([0, 1])
    assert "_cct_node" not in sub.events
    assert len(sub.cct) <= len(port.cct)


# ---------------------------------------------------------------------------
# what is not ported yet
# ---------------------------------------------------------------------------

def test_scan_and_the_plan_cache_are_not_yet_ported(tmp_path):
    with pytest.raises(NotImplementedError, match=r"ROADMAP §A\.3"):
        scan([str(tmp_path / "rank_0.jsonl")])
    port = to_port(tg.gol(nprocs=2, iters=1))
    with pytest.raises(NotImplementedError, match=r"ROADMAP §A\.4"):
        port.query().flat_profile(cache=True)
    assert isinstance(port.query(), TraceQuery)
