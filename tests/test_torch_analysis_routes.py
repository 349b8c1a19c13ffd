"""The rest of the analysis API on the port's routes.

``idle_time``, ``comm_by_process`` and ``comm_over_time`` have streaming
forms: each buffers its records and reduces them once at the end, so
every route gives the bits of the port's eager op on the same events —
streamed at 53 and 4,999 rows a chunk (under a plan too), over work units
(path units and byte-span units, in process and in a real spawn pool run
from a script on disk), from pack files, live (the incremental fold
against a ``cache=False`` handle at every watermark) and served.  The
eager op, in its turn, is the reference's eager op bit for bit.

The other new ops need the whole trace: on a streaming handle they raise
``StreamingUnsupported`` naming ``.collect()``.  ``TraceSet`` maps the
trace-scoped ops over its members.  ``comm_comp_breakdown``'s
``comm_matcher`` is a callable, which cannot cross the wire: both
packages refuse it in the client's encoder, before a request is sent.
"""

import asyncio
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro import tracegen as rtg
from repro.core.trace import Trace as RefTrace
from repro.serving import protocol as ref_protocol
from repro.serving.client import ServiceClient as RefServiceClient
from repro_torch import Trace, TraceSet
from repro_torch.core import (Filter, StreamingUnsupported, executor,
                              registry, streaming, time_window_filter)
from repro_torch.core.constants import NAME
from repro_torch.core.streaming import (CallStitcher, GlobalNames,
                                        LiveTrace, StreamContext,
                                        StreamingTrace, fold_frames)
from repro_torch.launch.cardcheck import digest
from repro_torch.readers import write_jsonl
from repro_torch.readers.pack import PackWriter
from repro_torch.serving import protocol
from repro_torch.serving.client import ServiceClient
from repro_torch.serving.protocol import ProtocolError, result_digest
from repro_torch.serving.tracequery import TraceService
from repro_torch.tracegen import big_events, big_trace

from test_torch_analysis import assert_same
from test_torch_ops import fresh_plan_cache  # noqa: F401
from test_torch_ops import to_port

#: the three ops with streaming forms
STREAMED = [
    ("idle_time", {}),
    ("idle_time", {"k": 2, "idle_functions": ["MPI_Wait", "MPI_Recv",
                                              "halo_exchange()"]}),
    ("comm_by_process", {}),
    ("comm_by_process", {"output": "count"}),
    ("comm_over_time", {"num_bins": 16}),
    ("comm_over_time", {"output": "count"}),
]
IDS = [f"{op}-{i}" for i, (op, _) in enumerate(STREAMED)]

#: the ops that need the whole trace
EAGER_ONLY = ["logical_steps", "calculate_lateness", "lateness_by_process",
              "critical_path_analysis", "activity_series", "detect_pattern",
              "comm_comp_breakdown"]

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """name -> paths: ``big_trace`` as 4 per-rank jsonl shards, the same
    shards joined into one file (byte-span units then cut calls), the
    gol and tortuga generators as one jsonl file each, and the shards as
    packs."""
    d = tmp_path_factory.mktemp("routes")
    kw = dict(nprocs=4, events_per_proc=1500, calls_per_iter=40, seed=3)
    shards = big_trace(str(d / "big"), **kw)
    joined = str(d / "joined.jsonl")
    with open(joined, "wb") as out:
        for p in shards:
            with open(p, "rb") as f:
                out.write(f.read())
    out = {"big_trace": shards, "joined": [joined],
           "packs": big_trace(str(d / "packs"), format="pack", **kw)}
    for name, ref in (("gol", rtg.gol(nprocs=4, iters=4, imbalance=0.5)),
                      ("tortuga", rtg.tortuga(nprocs=4, iters=3))):
        p = str(d / f"{name}.jsonl")
        write_jsonl(to_port(ref), p)
        out[name] = [p]
    return out


def _open(paths, **kw):
    return Trace.open(paths if len(paths) > 1 else paths[0], device="cpu",
                      **kw)


@pytest.mark.parametrize("op,kw", STREAMED, ids=IDS)
@pytest.mark.parametrize("chunk_rows", [53, 4_999])
@pytest.mark.parametrize("name", ["big_trace", "joined", "gol", "tortuga"])
def test_streamed_equals_eager_and_reference(files, name, chunk_rows, op,
                                             kw):
    paths = files[name]
    eager = _open(paths).run(op, **kw)
    st = _open(paths, streaming=True, chunk_rows=chunk_rows, cache=False)
    assert digest(st.run(op, **kw)) == digest(eager)
    ref = RefTrace.open(paths if len(paths) > 1 else paths[0])
    assert_same(eager, ref.query().run(op, **kw), f"{name} {op}")


def _plan(q):
    return (q.filter(Filter(NAME, "not-in", ["halo_exchange()"]))
            .restrict_processes(range(3))
            .filter(time_window_filter(1_000_000, 40_000_000,
                                       trim="within")))


@pytest.mark.parametrize("op,kw", STREAMED, ids=IDS)
@pytest.mark.parametrize("chunk_rows", [53, 4_999])
def test_plan_over_a_stream_equals_the_eager_selection(files, chunk_rows, op,
                                                       kw):
    """``filter`` + ``restrict_processes`` + a ``within`` window over the
    stream: the eager selection's bits, or the same IndexError where a
    message partner falls outside the selected ranks."""
    paths = files["big_trace"]
    st = _open(paths, streaming=True, chunk_rows=chunk_rows, cache=False)
    sub = _plan(_open(paths).query()).collect()
    try:
        want = sub.run(op, **kw)
    except IndexError:
        with pytest.raises(IndexError, match="partner"):
            _plan(st.query()).run(op, **kw)
        return
    assert digest(_plan(st.query()).run(op, **kw)) == digest(want)


def test_plan_selection_equals_the_reference_selection(files):
    """The eager selection's op results are the reference's on the same
    plan, for the ops whose partners stay inside it."""
    paths = files["big_trace"]
    got = _plan(_open(paths).query())
    from repro.core.filters import Filter as RefFilter
    from repro.core.filters import time_window_filter as ref_window
    want = (RefTrace.open(paths).query()
            .filter(RefFilter(NAME, "not-in", ["halo_exchange()"]))
            .restrict_processes(range(3))
            .filter(ref_window(1_000_000, 40_000_000, trim="within")))
    for op, kw in (STREAMED[0], STREAMED[1], STREAMED[4], STREAMED[5]):
        assert_same(got.run(op, **kw), want.run(op, **kw), op)


def test_partner_outside_the_selection_raises(files):
    """``tests/test_streaming.py``'s case on the port: restricting the
    ranks so that message partners fall outside fails loudly, in memory
    and streamed."""
    st = _open(files["gol"], streaming=True, chunk_rows=32, cache=False)
    with pytest.raises(IndexError, match="partner"):
        st.query().restrict_processes([0]).comm_by_process()
    with pytest.raises(IndexError):
        _open(files["gol"]).query().restrict_processes([0]).comm_by_process()


def test_negative_partner_wraps_to_the_last_rank(tmp_path):
    """A send to partner -1 counts as received by the last rank, on every
    route, as NumPy's indexing does in the reference."""
    rows = [(0, "Enter", "f", 0, -1, None), (1, "MpiSend", "MpiSend", 0, -1,
                                             64.0),
            (2, "MpiSend", "MpiSend", 1, 0, 32.0), (3, "Leave", "f", 0, -1,
                                                   None),
            (4, "Enter", "f", 2, -1, None), (5, "Leave", "f", 2, -1, None)]
    p = tmp_path / "neg.jsonl"
    with open(p, "w") as f:
        for ts, et, name, proc, partner, size in rows:
            rec = {"ts": ts, "et": et, "name": name, "proc": proc}
            if size is not None:
                rec.update(partner=partner, size=size)
            f.write(json.dumps(rec) + "\n")
    eager = Trace.open(str(p), device="cpu").comm_by_process()
    assert np.asarray(eager["received"]).tolist() == [32.0, 0.0, 64.0]
    for rows_ in (1, 2, 5):
        st = Trace.open(str(p), streaming=True, chunk_rows=rows_,
                        device="cpu", cache=False)
        assert digest(st.comm_by_process()) == digest(eager)
    assert_same(eager, RefTrace.open(str(p)).comm_by_process())


def test_partner_below_minus_one_follows_the_eager_op(tmp_path):
    """A fault of the reference's streamed ``comm_by_process``
    (ROADMAP §C): it credits every negative partner to the last rank,
    where its eager op indexes from the end (-2 is rank n - 2).  The
    port's stream reduces the records as its eager op does, and its fold
    parks a negative partner's weight until the rank count is known, so
    each gives the reference's eager result."""
    rows = [(0, "Enter", "f", 0, None), (1, "MpiSend", "MpiSend", 0, -2),
            (2, "MpiSend", "MpiSend", 1, 0), (3, "Leave", "f", 0, None),
            (4, "Enter", "f", 2, None), (5, "Leave", "f", 2, None)]
    p = str(tmp_path / "neg2.jsonl")
    with open(p, "w") as f:
        for ts, et, name, proc, partner in rows:
            rec = {"ts": ts, "et": et, "name": name, "proc": proc}
            if partner is not None:
                rec.update(partner=partner, size=64.0 if proc == 0 else 32.0)
            f.write(json.dumps(rec) + "\n")
    want = RefTrace.open(p).comm_by_process()
    assert np.asarray(want["received"]).tolist() == [32.0, 64.0, 0.0]
    ref_stream = RefTrace.open(p, streaming=True, chunk_rows=2)
    assert np.asarray(ref_stream.comm_by_process()["received"]).tolist() \
        == [32.0, 0.0, 64.0]
    assert_same(Trace.open(p, device="cpu").comm_by_process(), want)
    assert_same(Trace.open(p, streaming=True, chunk_rows=2, device="cpu",
                           cache=False).comm_by_process(), want)
    assert_same(Trace.open(p, streaming=True, chunk_rows=2, device="cpu",
                           cache=False, fold="chunks").comm_by_process(),
                want)


@pytest.mark.parametrize("op,kw", STREAMED, ids=IDS)
@pytest.mark.parametrize("chunk_rows", [7, 53])
def test_float_records_reduce_once_in_the_eager_order(op, kw, chunk_rows):
    """On float timestamps (a generator's, before any file rounds them to
    ns) the aggregator fed chunk by chunk gives the eager bits: the
    records are reduced once, in the order the eager op uses, whatever
    order the chunks delivered them in."""
    t = to_port(rtg.tortuga(nprocs=4, iters=3))
    frame = t.events.copy()          # before the eager op derives columns
    want = t.run(op, **kw)
    agg = registry.get_op(op).streaming(device="cpu", **kw)
    names = GlobalNames()
    stitcher = CallStitcher() if agg.needs_calls else None
    frames = (frame.take(np.arange(lo, min(lo + chunk_rows, len(frame))))
              for lo in range(0, len(frame), chunk_rows))
    proc_max = fold_frames(frames, agg, names, stitcher)
    open_calls = (stitcher.open_calls() if stitcher
                  else (np.empty(0, np.int64), np.empty(0, np.int64)))
    got = agg.result(StreamContext(names, open_calls, proc_max))
    assert digest(got) == digest(want)


# ---------------------------------------------------------------------------
# work units, in process and in a spawn pool
# ---------------------------------------------------------------------------

def run_units(paths, op, kw, n_units, chunk_rows=61):
    h = StreamingTrace(paths, chunk_rows=chunk_rows, device="cpu",
                       processes=2)
    spec = registry.get_op(op)
    kw = dict(kw, device="cpu")
    return executor.execute_parallel(h, (), spec, (), kw,
                                     spec.streaming(**kw), n_units=n_units,
                                     use_pool=False)


@pytest.mark.parametrize("op,kw", STREAMED, ids=IDS)
@pytest.mark.parametrize("n_units", [2, 7])
@pytest.mark.parametrize("name", ["big_trace", "joined", "packs"])
def test_units_give_the_eager_bits(files, name, n_units, op, kw):
    paths = files[name]
    eager = Trace.open(files["big_trace"], device="cpu").run(op, **kw)
    assert digest(run_units(paths, op, kw, n_units)) == digest(eager)


_SCRIPT = """
import sys, warnings
sys.path.insert(0, {src!r})
from repro_torch import Trace
from repro_torch.launch.cardcheck import digest


def main():
    warnings.simplefilter("error", RuntimeWarning)  # no degradation
    eager = Trace.open({shards!r}, device="cpu")
    for label, paths in (("path units", {shards!r}),
                         ("byte spans", {joined!r})):
        st = Trace.open(paths, streaming=True, chunk_rows=211,
                        processes=2, device="cpu", cache=False)
        for op, kw in {ops!r}:
            got = st.run(op, **kw)
            assert digest(got) == digest(eager.run(op, **kw)), (label, op)
            assert len(st.units_cuda) >= 2, st.units_cuda
            assert not any(st.units_cuda), st.units_cuda
        st._pool.close()
        print("POOLED", label, len(st.units_cuda))


if __name__ == "__main__":
    main()
"""


def test_spawn_pool_from_a_script_on_disk(files, tmp_path):
    """A real two-worker spawn pool (spawn workers re-import ``__main__``
    from the script file), over path units and byte-span units: every op
    the eager bits, no degradation, no worker on the card."""
    script = tmp_path / "run_pool.py"
    script.write_text(textwrap.dedent(_SCRIPT.format(
        src=SRC, shards=files["big_trace"], joined=files["joined"][0],
        ops=STREAMED)))
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("POOLED") == 2, out.stdout


# ---------------------------------------------------------------------------
# pack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op,kw", STREAMED, ids=IDS)
def test_pack_routes_give_the_eager_bits(files, tmp_path, op, kw):
    eager = Trace.open(files["big_trace"], device="cpu")
    want = digest(eager.run(op, **kw))
    one = str(tmp_path / "one.pack")
    eager.save_pack(one, chunk_rows=97)
    packs = files["packs"]
    routes = {
        "file": lambda: Trace.open(one, device="cpu"),
        "file streamed": lambda: Trace.open(one, streaming=True,
                                            chunk_rows=61, device="cpu",
                                            cache=False),
        "shards": lambda: Trace.open(packs, device="cpu"),
        "shards streamed": lambda: Trace.open(packs, streaming=True,
                                              chunk_rows=256, device="cpu",
                                              cache=False),
    }
    for route, make in routes.items():
        assert digest(make().run(op, **kw)) == want, route


# ---------------------------------------------------------------------------
# live: the incremental fold, cold handles and the eager route agree
# ---------------------------------------------------------------------------

GROUP = 128


@pytest.fixture(scope="module")
def ranks():
    from repro_torch.core.constants import PROC
    ev = big_events(nprocs=3, events_per_proc=900, calls_per_iter=30,
                    seed=5)
    procs = np.asarray(ev[PROC])
    return [ev.mask(procs == r) for r in range(3)]


def _append_rows(writers, frames, lo, hi):
    for w, f in zip(writers, frames):
        hi_r = min(hi, len(f))
        if hi_r > lo:
            w.append(f.take(np.arange(lo, hi_r)))
        w.commit()


@pytest.mark.parametrize("op,kw", STREAMED, ids=IDS)
def test_live_incremental_equals_cold_and_eager(tmp_path, ranks, op, kw):
    writers = [PackWriter.open_append(str(tmp_path / f"rank_{r}.pack"),
                                      chunk_rows=GROUP, fsync=False)
               for r in range(len(ranks))]
    paths = [w.path for w in writers]
    third = (max(len(f) for f in ranks) // 3 // GROUP + 1) * GROUP
    _append_rows(writers, ranks, 0, third)
    lt = LiveTrace(paths, device="cpu", chunk_rows=97)
    lt.run(op, **kw)
    fallbacks = streaming.INCREMENTAL_FALLBACKS
    for k in (1, 2):
        _append_rows(writers, ranks, k * third, (k + 1) * third)
        if k == 2:
            for w in writers:
                w.finalize(sidecar=False)
        lt.refresh()
        inc = lt.run(op, **kw)
        cold = LiveTrace(paths, device="cpu", chunk_rows=97,
                         cache=False).run(op, **kw)
        eager = lt.materialize().run(op, **kw)
        assert digest(inc) == digest(cold) == digest(eager), k
        assert lt.run(op, **kw) is inc      # no growth: the stored result
    assert lt.watermark.finalized
    assert streaming.INCREMENTAL_FALLBACKS == fallbacks


# ---------------------------------------------------------------------------
# served
# ---------------------------------------------------------------------------

def _payload(paths, op, kwargs=None, streaming=False):
    return {"open": {"paths": list(paths), "streaming": streaming},
            "op": op, "steps": [], "tenant": "t", "args": [],
            "kwargs": {k: protocol.encode_value(v)
                       for k, v in (kwargs or {}).items()}}


SERVED = STREAMED[::2] + [("detect_pattern", {"num_bins": 32,
                                              "max_patterns": 4}),
                          ("detect_pattern", {"start_event": "iteration"}),
                          ("activity_series", {"num_bins": 64}),
                          ("critical_path_analysis", {})]


@pytest.mark.parametrize("op,kw", SERVED,
                         ids=[f"{op}-{i}" for i, (op, _) in
                              enumerate(SERVED)])
def test_served_equals_the_library_and_a_repeat_hits(files, op, kw):
    """``/query``: the served result (decoded from the wire) has the
    library call's digest — ``detect_pattern``'s list of frames and
    ``comm_over_time``'s tuple included — and a repeat is a cache hit.
    The streamed ops are also served over a streaming handle."""
    packs = files["packs"]
    modes = [False, True] if (op, kw) in STREAMED else [False]

    async def main(streaming):
        svc = TraceService(device="cpu", max_handles=4)
        first = await svc.query(_payload(packs, op, kw, streaming))
        again = await svc.query(_payload(packs, op, kw, streaming))
        return first, again

    for mode in modes:
        first, again = asyncio.run(main(mode))
        got = protocol.decode_value(json.loads(json.dumps(first["result"])))
        lib = Trace.open(packs, streaming=mode, device="cpu",
                         **({"cache": False} if mode else {})).run(op, **kw)
        assert first["digest"] == result_digest(lib) == result_digest(got)
        assert digest(got) == digest(lib)
        assert again["cached"] and again["digest"] == first["digest"]


def test_comm_matcher_is_refused_by_the_client_encoder(files):
    """A callable cannot travel: both packages' clients raise
    ``ProtocolError`` while encoding the request, before anything is sent
    (no server listens on the port), and the service never sees it."""
    def matcher(name):
        return name.startswith("MPI")

    port = ServiceClient("127.0.0.1", 9)
    with pytest.raises(ProtocolError, match="function"):
        port.open(files["packs"]).query().comm_comp_breakdown(
            comm_matcher=matcher)
    ref = RefServiceClient("127.0.0.1", 9)
    with pytest.raises(ref_protocol.ProtocolError, match="function"):
        ref.open(files["packs"]).query().comm_comp_breakdown(
            comm_matcher=matcher)
    # without the callable the op is served like any other
    async def main():
        return await TraceService(device="cpu").query(
            _payload(files["packs"], "comm_comp_breakdown"))

    out = asyncio.run(main())
    lib = Trace.open(files["packs"], device="cpu").comm_comp_breakdown()
    assert out["digest"] == result_digest(lib)


# ---------------------------------------------------------------------------
# eager-only ops, sets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", EAGER_ONLY)
def test_eager_only_ops_refuse_a_stream(files, op):
    st = _open(files["big_trace"], streaming=True, chunk_rows=97)
    with pytest.raises(StreamingUnsupported, match=r"\.collect\(\)"):
        st.run(op)
    with pytest.raises(StreamingUnsupported, match=r"\.collect\(\)"):
        getattr(st.query().restrict_processes([0, 1]), op)()
    assert registry.get_op(op).streaming is None


@pytest.mark.parametrize("op,kw", STREAMED[::2], ids=IDS[::2])
def test_streamed_ops_are_parallel_safe(op, kw):
    assert registry.get_op(op).parallel_safe


def test_traceset_maps_the_new_ops_over_its_members(files):
    members = [rtg.gol(nprocs=2, iters=2, seed=s) for s in range(3)]
    ts = TraceSet([to_port(m) for m in members])
    ids = ts.idle_time()
    assert isinstance(ids, list) and len(ids) == 3
    for got, m in zip(ids, members):
        assert_same(got, m.idle_time())
    pats = ts.query().detect_pattern(start_event="compute_cells()")
    assert [len(p) for p in pats] == [len(m.detect_pattern(
        start_event="compute_cells()")) for m in members]
    streamed = TraceSet.open([files["big_trace"], files["big_trace"][:2]],
                             streaming=True, device="cpu")
    eager = TraceSet.open([files["big_trace"], files["big_trace"][:2]],
                          device="cpu")
    assert digest(streamed.comm_over_time()) == digest(eager.comm_over_time())


def test_no_new_op_is_a_set_op():
    for op in [o for o, _ in STREAMED] + EAGER_ONLY:
        assert registry.get_op(op).scope == "trace", op

