"""The port's live route: append-mode pack shards, ``LiveTrace`` with its
incremental re-query, the tracer's live sink, ``LiveTraceSet`` and the
service's ``/live`` sessions.

Mirrors ``tests/test_live.py``, its set cases included.  The shards are
written once by the port and read by both packages.  The load-bearing
properties:

* **pinned snapshot**: a live handle runs over the committed prefix it
  pinned at ``refresh()``; its result is the eager route's bits over the
  same committed rows;
* **incremental = cold**: after each growth the incremental result (only
  the new rows folded) is a ``cache=False`` cold pass's bits, for each of
  the six kernel-backed ops (seven calls), within the gate of the
  reference's live ``pallas`` route; a rewritten shard drops the stored
  state instead of folding onto it;
* **degraded coverage**: a rank whose heartbeat is older than
  ``dead_timeout`` is named in ``coverage.missing``, never dropped
  silently.
"""

import asyncio
import os
import subprocess
import sys
import textwrap
import time
import warnings

import numpy as np
import pytest
import torch

from repro.core import plancache as ref_plancache
from repro.core.streaming import LiveTrace as RefLiveTrace
from repro.readers import pack as ref_pack
from repro_torch import Trace
from repro_torch.core import accel, executor, plancache, registry
from repro_torch.core import streaming as port_streaming
from repro_torch.core.constants import (ENTER, ET, LEAVE, MSG_SIZE, NAME,
                                        PARTNER, PROC, TAG, TS)
from repro_torch.core.frame import EventFrame
from repro_torch.core.liveset import Coverage, LiveTraceSet
from repro_torch.core.streaming import LiveTrace, Watermark
from repro_torch.launch.cardcheck import digest
from repro_torch.readers.pack import PackWriter, committed_prefix, read_pack
from repro_torch.runtime.tracer import Tracer, read_heartbeat, \
    write_heartbeat
from repro_torch.serving.protocol import ProtocolError, result_digest
from repro_torch.serving.tracequery import ServiceError, TraceService
from repro_torch.tracegen import big_events

from test_torch_ops import fresh_plan_cache  # noqa: F401
from test_torch_ops import OPS, assert_equivalent
from test_torch_stragglers import assert_findings

TERMINALS = OPS + [("stragglers", {"threshold": -1.0})]
IDS = [f"{op}-{i}" for i, (op, _) in enumerate(TERMINALS)]
SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
#: rows a chunk group holds in the grown shards (commits land whole groups)
GROUP = 128


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _events(n, proc=0, t0=0):
    """n events of properly nested calls (Enter/Leave of one name, in
    turn), integer-ns timestamps."""
    names = np.repeat(np.asarray([f"fn{i % 7}" for i in range((n + 1) // 2)]),
                      2)[:n]
    et = np.asarray([ENTER if i % 2 == 0 else LEAVE for i in range(n)])
    return EventFrame({
        TS: np.arange(t0, t0 + n, dtype=np.int64), ET: et, NAME: names,
        PROC: np.full(n, proc, np.int64),
        PARTNER: np.full(n, -1, np.int64), MSG_SIZE: np.full(n, np.nan),
        TAG: np.zeros(n, np.int64)})


def _grow(path, n_commits=3, rows_per=120, proc=0):
    """Append ``n_commits`` committed groups; returns the writer."""
    w = PackWriter.open_append(path, fsync=False)
    base = committed_prefix(path)["rows"]
    for c in range(n_commits):
        w.append(_events(rows_per, proc=proc, t0=base + c * rows_per))
        w.commit()
    return w


@pytest.fixture(scope="module")
def ranks():
    """Per-rank frames of a 3-rank ``big_events`` trace (calls, messages
    and every op's inputs), in (process, time) order."""
    ev = big_events(nprocs=3, events_per_proc=900, calls_per_iter=30,
                    seed=5)
    procs = np.asarray(ev[PROC])
    return [ev.mask(procs == r) for r in range(3)]


def _append_rows(writers, frames, lo, hi):
    """Rows [lo, hi) of each rank onto its writer, one commit each."""
    for w, f in zip(writers, frames):
        hi_r = min(hi, len(f))
        if hi_r > lo:
            w.append(f.take(np.arange(lo, hi_r)))
        w.commit()


def _fleet_writers(d, frames):
    return [PackWriter.open_append(str(d / f"rank_{r}.pack"),
                                   chunk_rows=GROUP, fsync=False)
            for r in range(len(frames))]


def _eager_bits(lt, op, kw):
    """The eager route over the handle's committed rows."""
    return digest(lt.materialize().run(op, **kw))


def _ref_check(op, got, want, context):
    if op == "stragglers":
        assert_findings(got, want, context)
    else:
        assert_equivalent(op, got, want, context=context)


# ---------------------------------------------------------------------------
# append / commit / finalize, read by both packages
# ---------------------------------------------------------------------------

def test_append_commit_finalize_roundtrip(tmp_path):
    p = str(tmp_path / "a.pack")
    w = _grow(p, n_commits=3, rows_per=100)
    assert w.watermark["rows"] == 300 and w.watermark["groups"] == 3
    snap = committed_prefix(p)
    assert snap["rows"] == 300 and not snap["finalized"]
    assert ref_pack.committed_prefix(p)["rows"] == 300
    assert len(read_pack(p, live=True, device="cpu").events) == 300
    w.finalize(sidecar=False)
    assert committed_prefix(p)["finalized"]
    assert len(Trace.open(p, device="cpu").events) == 300


def test_uncommitted_tail_is_invisible(tmp_path):
    p = str(tmp_path / "a.pack")
    w = _grow(p, n_commits=2, rows_per=100)
    w.append(_events(50, t0=200))
    assert committed_prefix(p)["rows"] == 200
    assert len(read_pack(p, live=True, device="cpu").events) == 200
    w.commit()
    assert committed_prefix(p)["rows"] == 250


def test_crash_consistency_any_truncation_point(tmp_path):
    """Cut the shard at any byte: the port's committed prefix is the
    longest run of whole commits, the reference's on the same bytes, and
    its rows are what a clean writer stopped at that commit wrote."""
    p = str(tmp_path / "full.pack")
    w = _grow(p, n_commits=4, rows_per=80)
    with open(p, "rb") as f:
        data = f.read()
    w.finalize(sidecar=False)
    ref = {}
    for k in range(1, 5):
        rp = str(tmp_path / f"ref{k}.pack")
        _grow(rp, n_commits=k, rows_per=80).finalize(sidecar=False)
        ref[k] = result_digest(read_pack(rp, live=True, device="cpu").events)
    seen = set()
    for cut in sorted({0, len(data)} | set(range(0, len(data), 211))):
        t = str(tmp_path / "cut.pack")
        with open(t, "wb") as f:
            f.write(data[:cut])
        snap = committed_prefix(t)
        assert snap["rows"] % 80 == 0, f"partial commit visible at {cut}"
        assert snap["rows"] == ref_pack.committed_prefix(t)["rows"], cut
        k = snap["rows"] // 80
        seen.add(k)
        if k:
            got = read_pack(t, live=True, device="cpu").events
            assert result_digest(got) == ref[k], f"cut at {cut}"
    assert len(seen) >= 3


def test_resume_append_after_torn_tail(tmp_path):
    p = str(tmp_path / "a.pack")
    w = _grow(p, n_commits=2, rows_per=100)
    w._out.close()
    with open(p, "ab") as f:
        f.write(os.urandom(37))
    w2 = PackWriter.open_append(p, fsync=False)
    assert w2.watermark["rows"] == 200
    w2.append(_events(60, t0=200))
    w2.commit()
    w2.finalize(sidecar=False)
    assert len(Trace.open(p, device="cpu").events) == 260


def test_committed_prefix_missing_and_empty(tmp_path):
    missing = str(tmp_path / "nope.pack")
    assert committed_prefix(missing)["rows"] == 0
    p = str(tmp_path / "empty.pack")
    PackWriter.open_append(p, fsync=False)
    assert committed_prefix(p)["rows"] == 0
    lt = LiveTrace([missing, p], device="cpu")
    assert lt.watermark.rows == 0
    assert len(lt.query().flat_profile()) == 0


# ---------------------------------------------------------------------------
# watermarked incremental queries
# ---------------------------------------------------------------------------

def test_livetrace_pinning_and_refresh(tmp_path):
    p = str(tmp_path / "a.pack")
    w = _grow(p, n_commits=2, rows_per=100)
    lt = LiveTrace([p], device="cpu")
    assert lt.watermark.rows == 200
    w.append(_events(100, t0=200))
    w.commit()
    assert lt.watermark.rows == 200                  # pinned ...
    assert len(lt.query().run("flat_profile")) > 0
    assert lt.query().collect().events[TS].max() < 200
    assert lt.refresh().rows == 300                  # ... until refresh


@pytest.mark.parametrize("op,kw", TERMINALS, ids=IDS)
def test_incremental_requery_equals_cold(tmp_path, ranks, op, kw):
    """Three ranks grow in three commits each, the last with ``finalize``.
    After every growth the incremental result (cache on) is the bits of a
    cold ``cache=False`` handle and of the eager route over the same
    committed rows, within the gate of the reference's live ``pallas``
    route; it is another result than the first watermark's, no op fell
    back to the full pass, and the sealed footer's groups extend the
    folded prefix (nothing was invalidated)."""
    writers = _fleet_writers(tmp_path, ranks)
    paths = [w.path for w in writers]
    third = (max(len(f) for f in ranks) // 3 // GROUP + 1) * GROUP
    _append_rows(writers, ranks, 0, third)
    lt = LiveTrace(paths, device="cpu", chunk_rows=97)
    first = digest(lt.run(op, **kw))
    fallbacks = port_streaming.INCREMENTAL_FALLBACKS
    invalidations = plancache.stats()["live_invalidations"]
    for k in (1, 2):
        _append_rows(writers, ranks, k * third, (k + 1) * third)
        if k == 2:
            for w in writers:
                w.finalize(sidecar=False)
        lt.refresh()
        inc = lt.run(op, **kw)
        cold = LiveTrace(paths, device="cpu", chunk_rows=97,
                         cache=False).run(op, **kw)
        assert digest(inc) == digest(cold) == _eager_bits(lt, op, kw)
        ref_plancache.clear()
        want = RefLiveTrace(paths, chunk_rows=97, cache=False).query().run(
            op, cache=False, backend="pallas", **kw)
        _ref_check(op, inc, want, f"{op} at {lt.watermark.rows} rows")
    assert lt.watermark.rows == sum(len(f) for f in ranks)
    assert lt.watermark.finalized and digest(inc) != first
    assert port_streaming.INCREMENTAL_FALLBACKS == fallbacks
    assert plancache.stats()["live_hits"] >= 2
    assert plancache.stats()["live_invalidations"] == invalidations


def test_repeat_without_growth_returns_the_stored_result(tmp_path, ranks,
                                                         monkeypatch):
    """With no new rows the live entry answers: the same object, and no
    kernel call (the adapters are never reached)."""
    writers = _fleet_writers(tmp_path, ranks)
    _append_rows(writers, ranks, 0, 2 * GROUP)
    lt = LiveTrace([w.path for w in writers], device="cpu")
    first = lt.flat_profile()
    calls = []
    monkeypatch.setattr(accel, "seg_sum",
                        lambda *a, **k: calls.append(a) or None)
    assert lt.flat_profile() is first
    assert calls == []


def test_result_leaves_the_stored_state_alone(tmp_path, ranks):
    """Finalizing twice gives the same bits, and so does folding more rows
    after a finalize: ``result()`` changes nothing it was given."""
    writers = _fleet_writers(tmp_path, ranks)
    _append_rows(writers, ranks, 0, GROUP)
    paths = [w.path for w in writers]
    lt = LiveTrace(paths, device="cpu")
    lt.load_imbalance()
    (entry,) = list(plancache._LIVE.values())
    ctx = port_streaming.StreamContext(entry.names,
                                       entry.stitcher.open_calls(),
                                       entry.proc_max)
    assert digest(entry.agg.result(ctx)) == digest(entry.agg.result(ctx))
    _append_rows(writers, ranks, GROUP, 3 * GROUP)
    lt.refresh()
    assert digest(lt.load_imbalance()) == digest(
        LiveTrace(paths, device="cpu", cache=False).load_imbalance())


def test_eager_streaming_parallel_agree_on_prefix(tmp_path, ranks):
    """On a pinned prefix (shards still open) the serial live route, its
    row-span work units (in-process) and the eager route give one set of
    bits."""
    writers = _fleet_writers(tmp_path, ranks)
    _append_rows(writers, ranks, 0, 3 * GROUP)
    paths = [w.path for w in writers]
    lt = LiveTrace(paths, device="cpu", chunk_rows=61, processes=2)
    assert all(u.hi <= 3 * GROUP for u in executor.plan_units(lt, (), 4))
    for op, kw in TERMINALS:
        spec = registry.get_op(op)
        okw = dict(kw, device=lt.device)
        par = executor.execute_parallel(lt, (), spec, (), okw,
                                        spec.streaming(**okw), n_units=5,
                                        use_pool=False)
        serial = LiveTrace(paths, device="cpu", chunk_rows=61).run(op, **kw)
        assert digest(par) == digest(serial) == _eager_bits(lt, op, kw), op


def test_run_with_watermark(tmp_path):
    p = str(tmp_path / "a.pack")
    _grow(p, n_commits=2, rows_per=100)
    lt = LiveTrace([p], device="cpu")
    value, wm = lt.run_with_watermark("flat_profile")
    assert isinstance(wm, Watermark)
    assert wm.rows == 200 and not wm.finalized and len(value) > 0
    assert wm.as_dict()["per_path"][p]["rows"] == 200


def test_incremental_invalidated_by_rewrite(tmp_path):
    """A shard replaced under the handle (other content, fewer rows) drops
    the stored state: the result is the cold pass's, not a fold onto the
    old one."""
    p = str(tmp_path / "a.pack")
    w = _grow(p, n_commits=2, rows_per=100)
    lt = LiveTrace([p], device="cpu")
    lt.flat_profile()
    inval = plancache.stats()["live_invalidations"]
    w._out.close()
    os.unlink(p)
    _grow(p, n_commits=1, rows_per=64)
    lt.refresh()
    got = lt.flat_profile()
    cold = LiveTrace([p], device="cpu", cache=False).flat_profile()
    assert digest(got) == digest(cold)
    assert plancache.stats()["live_invalidations"] == inval + 1


def test_open_live_via_trace_open(tmp_path):
    p = str(tmp_path / "a.pack")
    _grow(p, n_commits=1, rows_per=100)
    lt = Trace.open(p, live=True, device="cpu")
    assert isinstance(lt, LiveTrace) and lt.watermark.rows == 100
    with pytest.raises(ValueError):
        Trace.open(p, live=True, format="jsonl", device="cpu")


def test_live_entry_is_keyed_by_the_device(tmp_path):
    """A card result never answers a CPU call: the device is part of the
    live key and of the plan key."""
    p = str(tmp_path / "a.pack")
    _grow(p, n_commits=1, rows_per=100)
    lt = LiveTrace([p], device="cpu")
    spec = registry.get_op("flat_profile")
    keys = {plancache.live_plan_key(lt, (), spec, (), {"device": d})
            for d in (torch.device("cpu"), torch.device("cuda"))}
    st = Trace.open(p, streaming=True, device="cpu")
    keys |= {plancache.plan_key(st.query()._source, (), spec, (),
                                {"device": d}, None)
             for d in (torch.device("cpu"), torch.device("cuda"))}
    assert len(keys) == 4 and None not in keys


def test_live_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")
    p = str(tmp_path / "a.pack")
    _grow(p, n_commits=1, rows_per=100)
    for make in (lambda: Trace.open(p, live=True),
                 lambda: LiveTrace([p]),
                 lambda: LiveTraceSet(str(tmp_path))):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


_SCRIPT = """
import sys, warnings
sys.path.insert(0, {src!r})
from repro_torch import Trace
from repro_torch.core.scheduler import get_scheduler
from repro_torch.launch.cardcheck import digest


def main():
    warnings.simplefilter("error", RuntimeWarning)  # no degradation
    lt = Trace.open({paths!r}, live=True, chunk_rows=97, processes=2,
                    device="cpu")
    eager = lt.materialize()
    for op, kw in {ops!r}:
        assert digest(lt.run(op, **kw)) == digest(eager.run(op, **kw)), op
        assert len(lt.units_cuda) >= 2 and not any(lt.units_cuda)
    assert lt._pool is get_scheduler().spawn_pool(2)
    get_scheduler().shutdown()
    print("POOLED", len(lt.units_cuda))


if __name__ == "__main__":
    main()
"""


def test_pooled_live_route_uses_the_scheduler_pool(tmp_path, ranks):
    """Unfinalized shards through a real two-worker spawn pool (a script on
    disk, so the workers can import ``__main__``): each op the eager bits
    of the pinned rows, no unit on the card, and the pool the shared
    scheduler's."""
    writers = _fleet_writers(tmp_path, ranks)
    _append_rows(writers, ranks, 0, 4 * GROUP)
    script = tmp_path / "run_pool.py"
    script.write_text(textwrap.dedent(_SCRIPT.format(
        src=SRC, paths=[w.path for w in writers], ops=TERMINALS)))
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("POOLED"), out.stdout


# ---------------------------------------------------------------------------
# tracer: bounded buffer, heartbeats
# ---------------------------------------------------------------------------

def test_tracer_bounded_buffer_spills_to_shard(tmp_path):
    sink = str(tmp_path / "rank_0.pack")
    tr = Tracer(process=0, sink=sink, flush_every=64, fsync=False)
    for _ in range(400):
        tr.instant("tick")
        assert len(tr.ts) < 64
    snap = committed_prefix(sink)
    assert snap["rows"] + len(tr.ts) == 400
    hb = read_heartbeat(sink)
    assert hb["rank"] == 0 and hb["events"] == snap["rows"]
    assert not hb["final"]
    tr.close()
    assert read_heartbeat(sink)["final"]
    assert len(Trace.open(sink, device="cpu").events) == 400


def test_tracer_heartbeat_on_wall_clock(tmp_path):
    fake = [1000.0]
    sink = str(tmp_path / "rank_0.pack")
    tr = Tracer(process=1, sink=sink, flush_every=100_000,
                heartbeat_interval=1.0, fsync=False,
                wall_clock=lambda: fake[0])
    for _ in range(300):
        tr.instant("x")
    assert committed_prefix(sink)["rows"] == 0
    fake[0] += 5.0
    for _ in range(300):
        tr.instant("x")
    assert committed_prefix(sink)["rows"] > 0
    tr.close(finalize=False)
    assert committed_prefix(sink)["rows"] == 600
    assert not committed_prefix(sink)["finalized"]


def test_tracer_without_sink_warns_once_keeps_events():
    tr = Tracer(max_buffer_events=10)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(25):
            tr.instant("x")
    warned = [w for w in caught if issubclass(w.category, RuntimeWarning)]
    assert len(warned) == 1 and "sink" in str(warned[0].message)
    assert len(tr.to_trace(device="cpu").events) == 25


# ---------------------------------------------------------------------------
# rank-failure tolerance
# ---------------------------------------------------------------------------

def _fleet(tmp_path, nranks, clock, rows=120):
    tracers = []
    for r in range(nranks):
        tr = Tracer(process=r, sink=str(tmp_path / f"rank_{r}.pack"),
                    flush_every=50, fsync=False, wall_clock=clock)
        for i in range(rows):
            with tr.span(f"fn{i % 5}", proc=r):
                tr.message("send", partner=(r + 1) % nranks, size=i + 1.0,
                           proc=r)
        tr.flush()
        tracers.append(tr)
    return tracers


def test_liveset_classification_and_degraded_query(tmp_path):
    fake = [1000.0]
    clock = lambda: fake[0]                                     # noqa: E731
    tracers = _fleet(tmp_path, 4, clock)
    ls = LiveTraceSet(str(tmp_path), lag_timeout=2.0, dead_timeout=10.0,
                      clock=clock, device="cpu")
    cov = ls.coverage
    assert cov.included == [0, 1, 2, 3] and not cov.degraded
    base_rows = ls.watermark.rows
    fake[0] += 5.0
    for r in range(3):
        tracers[r].instant("t", proc=r)
        tracers[r].flush()
    cov = ls.refresh()
    assert cov.per_rank[3]["status"] == "lagging" and 3 in cov.included
    fake[0] += 8.0
    for r in range(3):
        tracers[r].flush()
    val, cov, wm = ls.run("flat_profile")
    assert cov.per_rank[3]["status"] == "dead"
    assert cov.missing == [3] and cov.degraded
    assert cov.per_rank[3]["rows"] > 0
    assert wm.rows == base_rows - cov.per_rank[3]["rows"] + 3
    assert len(val) > 0 and cov.staleness_spread >= 0
    d = cov.as_dict()
    assert d["missing"] == [3] and d["per_rank"]["3"]["status"] == "dead"


@pytest.mark.parametrize("op,kw", TERMINALS, ids=IDS)
def test_liveset_survivor_digest_matches_direct_open(tmp_path, op, kw):
    """A back-dated rank is named missing; the survivors' result is the
    bits of a direct live open of their shards, and within the gate of the
    reference's live ``pallas`` route over them."""
    fake = [1000.0]
    clock = lambda: fake[0]                                     # noqa: E731
    _fleet(tmp_path, 3, clock)
    write_heartbeat(str(tmp_path / "rank_1.pack"), 1, 240, 1, 1,
                    wall=fake[0] - 100.0)
    ls = LiveTraceSet(str(tmp_path), clock=clock, device="cpu")
    val, cov, _wm = ls.run(op, **kw)
    assert cov.missing == [1]
    survivors = [str(tmp_path / "rank_0.pack"), str(tmp_path / "rank_2.pack")]
    direct = LiveTrace(survivors, device="cpu", cache=False).run(op, **kw)
    assert digest(val) == digest(direct)
    want = RefLiveTrace(survivors, cache=False).query().run(
        op, cache=False, backend="pallas", **kw)
    _ref_check(op, val, want, op)


def test_liveset_final_heartbeat_never_goes_dead(tmp_path):
    fake = [1000.0]
    clock = lambda: fake[0]                                     # noqa: E731
    tracers = _fleet(tmp_path, 2, clock)
    tracers[1].close()
    fake[0] += 100.0
    tracers[0].flush()
    ls = LiveTraceSet(str(tmp_path), clock=clock, device="cpu")
    assert ls.coverage.per_rank[1]["status"] == "live"
    assert ls.coverage.per_rank[1]["finalized"]
    assert not ls.coverage.degraded


def test_liveset_to_traceset_compares_the_survivors(tmp_path):
    """The survivors as a set of per-rank live handles labelled
    ``rank<r>``, on the set's device: a comparison over them equals the
    same comparison over direct live opens of each rank, and a dead rank
    is not a member."""
    from repro_torch import TraceSet
    fake = [1000.0]
    clock = lambda: fake[0]                                     # noqa: E731
    tracers = _fleet(tmp_path, 3, clock)
    fake[0] += 30.0
    for r in (0, 1):
        tracers[r].instant("t", proc=r)
        tracers[r].flush()
    ls = LiveTraceSet(str(tmp_path), lag_timeout=2.0, dead_timeout=10.0,
                      clock=clock, device="cpu")
    assert ls.coverage.missing == [2]
    ts = ls.to_traceset()
    assert ts.labels == ["rank0", "rank1"]
    assert all(isinstance(m, LiveTrace) and m.device == ls.device
               for m in ts)
    direct = TraceSet([Trace.open([str(tmp_path / f"rank_{r}.pack")],
                                  live=True, device="cpu")
                       for r in (0, 1)], labels=["rank0", "rank1"])
    for op in ("regression_report", "diff_load_imbalance"):
        assert digest(ts.run(op)) == digest(direct.run(op)), op
    assert [digest(x) for x in ts.flat_profile()] == \
        [digest(x) for x in direct.flat_profile()]


def test_liveset_all_dead_raises(tmp_path):
    fake = [1000.0]
    clock = lambda: fake[0]                                     # noqa: E731
    _fleet(tmp_path, 2, clock)
    fake[0] += 1000.0
    ls = LiveTraceSet(str(tmp_path), clock=clock, device="cpu")
    assert ls.coverage.missing == [0, 1]
    with pytest.raises(RuntimeError, match="no surviving ranks"):
        ls.run("flat_profile")
    # no survivor: an empty set, which TraceSet refuses
    with pytest.raises(ValueError, match="at least one trace"):
        ls.to_traceset()
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(RuntimeError):
        LiveTraceSet(str(empty), clock=clock, device="cpu").run(
            "flat_profile")


def test_coverage_report_shape():
    cov = Coverage({
        0: {"status": "live", "path": "a", "rows": 10, "ts_max": 100,
            "finalized": False, "heartbeat_age": 0.1},
        1: {"status": "dead", "path": "b", "rows": 4, "ts_max": 40,
            "finalized": False, "heartbeat_age": 99.0},
        2: {"status": "lagging", "path": "c", "rows": 8, "ts_max": 70,
            "finalized": False, "heartbeat_age": 3.0},
    })
    assert cov.ranks_total == 3
    assert cov.included == [0, 2] and cov.missing == [1]
    assert cov.staleness_spread == 30
    assert cov.degraded


# ---------------------------------------------------------------------------
# service live sessions
# ---------------------------------------------------------------------------

def run(coro):
    return asyncio.run(coro)


def test_service_live_poll_backpressure_and_growth(tmp_path):
    p = str(tmp_path / "rank_0.pack")
    w = _grow(p, n_commits=2, rows_per=100)
    svc = TraceService(device="cpu")
    body = {"open": {"path": p, "mode": "live"}, "op": "flat_profile",
            "tenant": "t"}
    out = run(svc.live(body))
    assert out["ok"] and out["watermark"]["rows"] == 200
    assert out["advanced_rows"] == 200 and not out["partial"]
    want = LiveTrace([p], device="cpu", cache=False).flat_profile()
    assert out["digest"] == result_digest(want)
    with pytest.raises(ServiceError) as exc:
        run(svc.live(body))
    assert exc.value.status == 429
    assert exc.value.code == "watermark_stalled"
    assert exc.value.extra["retry_after_ms"] > 0
    assert svc.counters["live_stalled"] == 1
    assert run(svc.live(dict(body, session="other")))["ok"]
    w.append(_events(80, t0=200))
    w.commit()
    out3 = run(svc.live(body))
    assert out3["watermark"]["rows"] == 280 and out3["advanced_rows"] == 80
    assert svc.counters["live_polls"] == 4


def test_service_liveset_partial_responses(tmp_path):
    for r in range(3):
        tr = Tracer(process=r, sink=str(tmp_path / f"rank_{r}.pack"),
                    flush_every=40, fsync=False)
        for i in range(80):
            with tr.span(f"fn{i % 5}", proc=r):
                pass
        tr.flush()
    svc = TraceService(device="cpu")
    body = {"open": {"path": str(tmp_path), "mode": "liveset",
                     "lag_timeout": 5.0, "dead_timeout": 60.0},
            "op": "flat_profile", "min_advance_rows": 0, "tenant": "t"}
    out = run(svc.live(body))
    assert not out["partial"] and out["coverage"]["included"] == [0, 1, 2]
    write_heartbeat(str(tmp_path / "rank_2.pack"), 2, 160, 1, 9,
                    wall=time.time() - 120.0)
    out = run(svc.live(body))
    assert out["partial"] and out["missing_ranks"] == [2]
    assert out["coverage"]["per_rank"]["2"]["status"] == "dead"
    assert svc.counters["live_partial"] == 1
    for r in (0, 1):
        write_heartbeat(str(tmp_path / f"rank_{r}.pack"), r, 160, 1, 9,
                        wall=time.time() - 120.0)
    with pytest.raises(ServiceError) as exc:
        run(svc.live(body))
    assert exc.value.status == 503 and exc.value.code == "no_survivors"
    assert exc.value.extra["coverage"]["missing"] == [0, 1, 2]


def test_query_endpoint_rejects_live_modes(tmp_path):
    p = str(tmp_path / "a.pack")
    _grow(p, n_commits=1, rows_per=50)
    svc = TraceService(device="cpu")
    with pytest.raises(ProtocolError, match="/live"):
        run(svc.query({"open": {"path": p, "mode": "live"},
                       "op": "flat_profile"}))
    with pytest.raises(ProtocolError, match="/live takes"):
        run(svc.live({"open": {"path": p, "mode": "set"},
                      "op": "flat_profile"}))
    with pytest.raises(ProtocolError, match="set-scoped"):
        run(svc.live({"open": {"path": p, "mode": "live"},
                      "op": "regression_report"}))


def test_live_handle_not_reopened_on_growth(tmp_path):
    p = str(tmp_path / "a.pack")
    w = _grow(p, n_commits=1, rows_per=100)
    svc = TraceService(device="cpu")
    body = {"open": {"path": p, "mode": "live"}, "op": "flat_profile",
            "tenant": "t"}
    run(svc.live(body))
    for _ in range(3):
        w.append(_events(60, t0=committed_prefix(p)["rows"]))
        w.commit()
        run(svc.live(body))
    st = svc.handles.stats()
    assert st["opens"] == 1 and st["reopens"] == 0
    assert st["device"] == "cpu"


def test_live_set_follows_the_watermark(tmp_path):
    """A set of live members compared again after growth and ``refresh()``
    covers the new rows: the profiles a set op shares are keyed by each
    member's pinned snapshot."""
    from repro_torch import TraceSet
    paths = [str(tmp_path / f"rank_{r}.pack") for r in range(2)]
    writers = [_grow(p, n_commits=1, rows_per=100, proc=r)
               for r, p in enumerate(paths)]
    ts = TraceSet([Trace.open([p], live=True, device="cpu") for p in paths],
                  labels=["a", "b"])
    before = ts.regression_report()
    for r, w in enumerate(writers):
        w.append(_events(60, proc=r, t0=committed_prefix(paths[r])["rows"]))
        w.commit()
    for m in ts:
        m.refresh()
    after = ts.regression_report()
    cold = TraceSet([Trace.open([p], live=True, cache=False, device="cpu")
                     for p in paths], labels=["a", "b"]).regression_report()
    assert digest(after) == digest(cold) != digest(before)
