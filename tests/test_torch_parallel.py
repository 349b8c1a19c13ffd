"""The port's parallel work-unit route: ``execute_parallel`` over byte-span
and per-shard units, ``Trace.open(paths, processes=N)``, shard skipping and
``scan``.

Units run in-process here (``use_pool=False``, as ``tests/test_executor.py``
runs the reference's): under pytest-xdist ``__main__`` has no file, so the
spawn-safety rule refuses a pool.  The real pool is driven from a script on
disk in a subprocess (:func:`test_spawn_pool_from_a_script_on_disk`).  For
each of the six ops the units give the bits of the serial streaming route
and of the eager route (the same records reach the kernel in the same
canonical order), at 2, 7 and 19 units, byte spans cutting through calls,
and agree with the reference's parallel ``pallas`` route within
``tests/test_torch_ops.py``'s tolerance.
"""

import os
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest

from repro import tracegen as tg
from repro.core import executor as ref_ex
from repro.core import registry as ref_registry
from repro.core.filters import Filter as RefFilter
from repro.core.query import scan as ref_scan
from repro.core.streaming import CallStitcher as RefStitcher
from repro.core.streaming import GlobalNames as RefNames
from repro.core.streaming import StreamingTrace as RefStreamingTrace
from repro.core.trace import Trace as RefTrace
from repro.readers import jsonl as ref_jsonl
from repro.readers import parallel as ref_parallel
from repro_torch import Trace
from repro_torch.core import (Filter, StreamingUnsupported, executor,
                              plancache, registry)
from repro_torch.core.constants import NAME, PROC, TS
from repro_torch.core.query import scan
from repro_torch.core.streaming import (CallStitcher, GlobalNames,
                                        StreamingTrace)
from repro_torch.launch.cardcheck import digest
from repro_torch.readers import jsonl, parallel, write_jsonl
from repro_torch.tracegen import big_trace

from test_torch_ops import fresh_plan_cache  # noqa: F401
from test_torch_ops import OPS, assert_equivalent, to_port
from test_torch_stragglers import assert_findings

TERMINALS = OPS + [("stragglers", {"threshold": -1.0})]
IDS = [f"{op}-{i}" for i, (op, _) in enumerate(TERMINALS)]
UNITS = [2, 7, 19]
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """name -> jsonl paths: the straggler pathology trace as one file, a
    small ``big_trace`` as four per-rank shards, and the same shards
    joined into one file (byte spans then cut through calls of every
    rank)."""
    d = tmp_path_factory.mktemp("par")
    tr, _gt = tg.pathology_trace("straggler", nprocs=4, iters=24,
                                 magnitude=2.0, seed=11)
    one = str(d / "straggler.jsonl")
    write_jsonl(to_port(tr), one)
    shards = big_trace(str(d / "big"), nprocs=4, events_per_proc=1500,
                       calls_per_iter=40, seed=3)
    joined = str(d / "joined.jsonl")
    with open(joined, "wb") as out:
        for p in shards:
            with open(p, "rb") as f:
                out.write(f.read())
    return {"straggler": [one], "big_trace": shards, "joined": [joined]}


def _handle(paths, chunk_rows=61, **kw):
    return StreamingTrace(paths, chunk_rows=chunk_rows, device="cpu",
                          processes=2, **kw)


def run_units(paths, op, kw, n_units, steps=(), chunk_rows=61):
    """The parallel route with in-process units."""
    h = _handle(paths, chunk_rows)
    spec = registry.get_op(op)
    kw = dict(kw, device="cpu")
    return executor.execute_parallel(h, tuple(steps), spec, (), kw,
                                     spec.streaming(**kw), n_units=n_units,
                                     use_pool=False)


def _eager(paths):
    return Trace.open(paths if len(paths) > 1 else paths[0], device="cpu")


@pytest.mark.parametrize("op,kw", TERMINALS, ids=IDS)
@pytest.mark.parametrize("n_units", UNITS)
@pytest.mark.parametrize("name", ["straggler", "joined", "big_trace"])
def test_units_give_the_serial_and_eager_bits(files, name, n_units, op, kw):
    paths = files[name]
    got = digest(run_units(paths, op, kw, n_units))
    serial = _handle(paths, executor="serial").run(op, **kw)
    assert got == digest(serial)
    assert got == digest(_eager(paths).run(op, **kw))


def _check(op, got, want, context):
    if op == "stragglers":
        assert_findings(got, want, context)
    else:
        assert_equivalent(op, got, want, context=context)


def _agrees(op, a, b) -> bool:
    try:
        _check(op, a, b, "")
        return True
    except AssertionError:
        return False


@pytest.mark.parametrize("op,kw", TERMINALS, ids=IDS)
@pytest.mark.parametrize("n_units", UNITS)
@pytest.mark.parametrize("name", ["straggler", "joined"])
def test_units_match_reference_parallel_pallas(files, name, n_units, op,
                                               kw):
    """Within tolerance of the reference's parallel ``pallas`` route, and
    always of its serial streaming route.  Where the reference's two
    routes disagree (its seam replay loses the call time of a unit's
    boundary-free first chunks, ROADMAP §C) the port is held to the serial
    one; on the joined file at 19 units that fault shows."""
    path = files[name][0]
    got = run_units([path], op, kw, n_units, chunk_rows=61)
    spec = ref_registry.get_op(op)
    rkw = dict(kw, backend="pallas")
    par = ref_ex.execute_parallel(
        RefStreamingTrace(path, chunk_rows=61, processes=2), (), spec, (),
        rkw, spec.streaming(**rkw), n_units=n_units, use_pool=False)
    serial = RefTrace.open(path, streaming=True, chunk_rows=61).query().run(
        op, cache=False, **rkw)
    context = f"{name} {op} n_units={n_units}"
    _check(op, got, serial, context)
    if _agrees(op, par, serial):
        _check(op, got, par, context)
    else:
        assert (name, n_units) == ("joined", 19), context


def _same_bits(got, want) -> None:
    """``got()`` gives ``want()``'s bits, or raises the IndexError it
    raises (a selection that cuts sends from their receiving rank)."""
    try:
        expected = digest(want())
    except IndexError:
        with pytest.raises(IndexError):
            got()
        return
    assert digest(got()) == expected


def _plan(q):
    return (q.filter(Filter(NAME, "not-in", ["halo_exchange()"]))
            .restrict_processes(range(3))
            .filter(Filter(TS, "between", (0, 4e9))))


@pytest.mark.parametrize("op,kw", TERMINALS, ids=IDS)
def test_units_under_a_plan_give_the_eager_selection(files, op, kw):
    """A plan's steps mask every unit's chunks (and push the process
    restriction into the shard selection)."""
    paths = files["big_trace"]
    eager = _plan(_eager(paths).query()).collect()
    steps = _plan(_handle(paths).query())._steps
    _same_bits(lambda: run_units(paths, op, kw, 7, steps=steps),
               lambda: eager.run(op, **kw))


@pytest.mark.parametrize("streaming", [True, False])
def test_open_takes_no_cache_argument(files, streaming):
    """``cache=`` is an argument of the streamed open since the plan cache
    is ported (the name is kept from when it was not), as in the
    reference: a streamed handle opened with ``cache=False`` stores
    nothing and gives the cached handle's bits, and an eager open refuses
    it (its control is the query terminal's per-call ``cache=``)."""
    paths = files["big_trace"]
    if not streaming:
        with pytest.raises(ValueError, match="cache only applies"):
            Trace.open(paths, streaming=False, cache=False, device="cpu")
        return
    entries = plancache.stats()["entries"]
    off = Trace.open(paths, streaming=True, cache=False, device="cpu")
    got = off.flat_profile()
    assert plancache.stats()["entries"] == entries
    on = Trace.open(paths, streaming=True, device="cpu")
    assert digest(on.flat_profile()) == digest(got)
    assert plancache.stats()["entries"] == entries + 1
    assert on.flat_profile() is on.flat_profile()


@pytest.mark.parametrize("n", [1, 2, 3, 7, 19, 10_000])
def test_plan_units_jsonl_partitions_the_events(files, n):
    path = files["joined"][0]
    spans = jsonl.plan_units_jsonl(path, n)
    ref = ref_jsonl.plan_units_jsonl(path, n)
    if spans is None:
        assert ref is None
        return
    assert [(s.lo, s.hi) for s in spans] == [(s.lo, s.hi) for s in ref]
    assert spans[0].lo == 0 and spans[-1].hi == os.path.getsize(path)
    whole = jsonl.read_jsonl(path, device="cpu").events
    names = GlobalNames()
    ts, nm = [], []
    for s in spans:
        for f in jsonl.iter_chunks_jsonl(path, 50,
                                         byte_range=(s.lo, s.hi)):
            ts.append(np.asarray(f[TS], np.int64))
            nm.append(names.encode(f.cat(NAME)))
    np.testing.assert_array_equal(np.concatenate(ts),
                                  np.asarray(whole[TS], np.int64))
    got = np.asarray(names.names, dtype=object)[np.concatenate(nm)]
    np.testing.assert_array_equal(got.astype(str), whole[NAME])


@pytest.mark.parametrize("procs,bounds", [
    ({1}, None), ({0, 3}, None), (None, (1, 2)), ({0, 2}, (1, 3)),
    (set(), None), (None, None)])
def test_select_shards_skips_what_the_reference_skips(files, procs, bounds):
    paths = files["big_trace"] + files["straggler"]
    got = parallel.select_shards(paths, procs=procs, proc_bounds=bounds)
    want = ref_parallel.select_shards(paths, procs=procs, proc_bounds=bounds)
    assert got == want
    assert files["straggler"][0] in got  # no hint: never skipped


def test_hints_drop_rows_while_parsing(files):
    path = files["joined"][0]
    hints = registry.PlanHints(procs=frozenset({1, 2}),
                               time_window=(0, 2e9))
    got = [f for f in jsonl.iter_chunks_jsonl(path, 97, hints)]
    want = list(ref_jsonl.iter_chunks_jsonl(
        path, 97, ref_registry.PlanHints(procs=frozenset({1, 2}),
                                         time_window=(0, 2e9))))
    for c in (TS, PROC):
        np.testing.assert_array_equal(
            np.concatenate([np.asarray(f[c], np.int64) for f in got]),
            np.concatenate([np.asarray(f[c], np.int64) for f in want]))


@pytest.mark.parametrize("op,kw", TERMINALS, ids=IDS)
def test_scan_skips_shards_and_gives_the_eager_selection(files, op, kw):
    paths = files["big_trace"]
    sel = Filter(PROC, "in", [1, 2])
    q = scan(paths, device="cpu").filter(sel)
    assert "pushdown: procs=None bounds=(1.0, 2.0)" in q.explain()
    want = _eager(paths).query().filter(sel).collect()
    _same_bits(lambda: q.run(op, **kw), lambda: want.run(op, **kw))
    ref = ref_parallel.select_shards(paths, proc_bounds=(1.0, 2.0))
    assert len(ref) == 2 and q.collect().num_processes == 3


def test_scan_reads_only_the_kept_shards(files, monkeypatch):
    paths = files["big_trace"]
    seen = []
    real = parallel._read_one
    monkeypatch.setattr(parallel, "_read_one",
                        lambda a: seen.append(a[1]) or real(a))
    t = scan(paths, device="cpu").restrict_processes([3]).collect()
    assert seen == [paths[3]]
    assert set(np.unique(np.asarray(t.events[PROC]))) == {3}
    ref = RefTrace.open(paths[3])
    assert len(t) == len(ref)


def test_trace_open_list_reads_through_read_parallel(files):
    paths = files["big_trace"]
    t = Trace.open(paths, device="cpu", processes=2)
    ref = ref_parallel.read_parallel(paths, processes=1)
    assert t.label == "parallel[4]"
    for c in (TS, PROC):
        np.testing.assert_array_equal(np.asarray(t.events[c], np.int64),
                                      np.asarray(ref.events[c], np.int64))
    np.testing.assert_array_equal(t.events[NAME], ref.events[NAME])
    many = parallel.open_many([paths[0], paths[1:]], device="cpu")
    assert [len(m) for m in many] == [len(RefTrace.open(paths[0])),
                                      len(ref) - len(RefTrace.open(paths[0]))]
    with pytest.raises(ValueError, match="processes"):
        Trace.open(paths[0], device="cpu", processes=2)


def test_split_jsonl_by_process_matches_reference(files, tmp_path):
    got = parallel.split_jsonl_by_process(files["joined"][0],
                                          str(tmp_path / "a"))
    want = ref_parallel.split_jsonl_by_process(files["joined"][0],
                                               str(tmp_path / "b"))
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    for a, b in zip(got, want):
        assert open(a, "rb").read() == open(b, "rb").read()


def test_deferring_stitcher_matches_reference(files):
    """Worker mode: the seam events, trailing frames and group spans of a
    unit that starts mid-stream are the reference stitcher's."""
    path = files["joined"][0]
    size = os.path.getsize(path)
    port, ref = CallStitcher(defer_unmatched=True), \
        RefStitcher(defer_unmatched=True)
    pn, rn = GlobalNames(), RefNames()
    span = (size // 3, 2 * size // 3)
    for f, g in zip(jsonl.iter_chunks_jsonl(path, 89, byte_range=span),
                    ref_jsonl.iter_chunks_jsonl(path, 89, byte_range=span)):
        a = port.push_chunk(f, pn.encode(f.cat(NAME)))
        b = ref.push_chunk(g, rn.encode(g.cat(NAME)))
        for c in ("name", "proc", "start", "end", "inc", "exc"):
            np.testing.assert_array_equal(getattr(a, c), getattr(b, c))
    assert port.seams() == ref.seams() and port.seams()
    assert port.trailing() == ref.trailing()
    assert port.group_span() == ref.group_span()


@pytest.mark.parametrize("steps", [
    lambda q, F: q.restrict_processes([0, 1, 2]).filter(F(PROC, "in", [1, 3])),
    lambda q, F: q.filter(F(PROC, ">=", 1)).restrict_processes([0, 2, 3]),
    lambda q, F: q.filter(F(PROC, "in", [2])).filter(F(PROC, "<=", 1)),
])
def test_scan_pushdown_folds_the_steps_as_the_reference_does(files, steps):
    """explain()'s pushdown line and the shards ``collect`` reads: the
    conjunction of every step's process restriction, as the reference
    folds it."""
    paths = files["big_trace"]
    got = steps(scan(paths, device="cpu"), Filter)
    want = steps(ref_scan(paths), RefFilter)
    assert got.explain().splitlines()[1:] == want.explain().splitlines()[1:]
    assert "pushdown:" in got.explain()
    t, r = got.collect(), want.collect()
    assert t.label == r.label and len(t) == len(r)


def test_unit_plans_are_cached_and_replanned_on_growth(files, tmp_path):
    p = str(tmp_path / "grow.jsonl")
    with open(p, "wb") as f:
        f.write(open(files["joined"][0], "rb").read())
    h = _handle([p])
    first = executor.plan_units(h, (), 3)
    assert executor.plan_units(h, (), 3) is first
    with open(p, "ab") as f:
        f.write(open(files["big_trace"][3], "rb").read())
    os.utime(p, ns=(1, 1))
    second = executor.plan_units(h, (), 3)
    assert second is not first and second[-1].hi == os.path.getsize(p)


def test_degradations_warn_with_the_reason(files, monkeypatch):
    paths = files["straggler"]
    h = Trace.open(paths[0], streaming=True, device="cpu", processes=2)
    monkeypatch.setattr(executor, "spawn_unsafe_reason",
                        lambda: "__main__ has no importable file")
    with pytest.warns(RuntimeWarning, match="degraded to serial: __main__"):
        got = h.flat_profile()
    assert digest(got) == digest(_eager(paths).flat_profile())
    one = Trace.open(paths[0], streaming=True, device="cpu",
                     executor="parallel", processes=1)
    with pytest.warns(RuntimeWarning, match="processes=1"):
        one.comm_matrix()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        Trace.open(paths[0], streaming=True, device="cpu",
                   processes=2, executor="serial").flat_profile()


def test_units_refuse_interleaved_time_order(tmp_path):
    p = str(tmp_path / "unsorted.jsonl")
    with open(p, "w") as f:
        for ts in (100, 200, 50, 60):
            f.write(f'{{"ts":{ts},"et":"Instant","name":"x","proc":0}}\n')
    with pytest.raises(StreamingUnsupported, match="work units"):
        run_units([p], "flat_profile", {}, 2, chunk_rows=1)


_SCRIPT = """
import sys, warnings
sys.path.insert(0, {src!r})
from repro_torch import Trace
from repro_torch.launch.cardcheck import digest


def main():
    warnings.simplefilter("error", RuntimeWarning)  # no degradation
    st = Trace.open({paths!r}, streaming=True, chunk_rows=211,
                    processes=2, device="cpu")
    eager = Trace.open({paths!r}, device="cpu")
    for op, kw in {ops!r}:
        assert digest(st.run(op, **kw)) == digest(eager.run(op, **kw)), op
        assert len(st.units_cuda) >= 2, st.units_cuda
        assert not any(st.units_cuda), st.units_cuda
    pool = st._pool
    assert pool is not None and pool._pool is not None
    pool.close()
    print("POOLED", len(st.units_cuda))


if __name__ == "__main__":
    main()
"""


def test_spawn_pool_from_a_script_on_disk(files, tmp_path):
    """A real two-worker spawn pool run from a script file (spawn
    workers re-import ``__main__`` from it); every op gives the eager bits,
    no degradation warning is raised and no worker initializes CUDA."""
    script = tmp_path / "run_pool.py"
    script.write_text(textwrap.dedent(_SCRIPT.format(
        src=SRC, paths=files["big_trace"], ops=TERMINALS)))
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("POOLED"), out.stdout
