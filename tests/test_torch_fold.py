"""The port's bounded-memory streaming: ``Trace.open(..., fold="chunks")``.

With ``fold="chunks"`` each chunk's records go to one launch of the op's
kernel (here, on the CPU, its plain version) and the result is added into
float64 state sized by names x processes (x bins); the records are then
dropped.  The host ops (``comm_over_time``, ``idle_time``,
``comm_by_process``, the POP pair and the host detectors) fold each
chunk in NumPy and launch nothing; ``diagnose`` folds every detector's
state in one pass.  For each op that folds (``flat_profile`` in both
layouts), at 61, 97 and 4,999 rows a chunk, the result must be within
``cardcheck.gate`` of the port's eager route and of the reference's
streaming route (``backend="numpy"`` where the op takes one: the same
kind of state), with counts, bin edges and the host detectors' findings
exact; it must be the same bits on relaunch.  The statistics pre-pass
must equal the reference's, serially and over work units; the parallel
fold must agree with the serial one; a live fold must fold only the new
rows into state whose size does not move (or take the full pass when it
needs the pre-pass); and the state must not grow with the trace, but
``late_sender``'s message instants, while the buffering route's memory
does.
"""

import os
import subprocess
import sys
import textwrap
import tracemalloc

import numpy as np
import pytest

from repro import tracegen as tg
from repro.core import streaming as ref_streaming
from repro.core.trace import Trace as RefTrace
from repro_torch import Trace
from repro_torch.core import (StreamingTrace, StreamingUnsupported, TraceSet,
                              executor, plancache, registry)
from repro_torch.core import streaming as port_streaming
from repro_torch.core.constants import MPI_SEND, NAME
from repro_torch.core.streaming import LiveTrace
from repro_torch.launch.cardcheck import digest, op_gate
from repro_torch.readers import write_jsonl
from repro_torch.readers.pack import PackWriter
from repro_torch.tracegen import big_events, big_trace

from test_torch_ops import fresh_plan_cache  # noqa: F401
from test_torch_ops import to_port

#: the op calls that fold (``flat_profile`` in both layouts): the six
#: kernel-backed ops first, then the host ops and ``diagnose``
FOLDS = [
    ("flat_profile", {"metrics": ("time.exc", "time.inc")}),
    ("flat_profile", {"per_process": True}),
    ("time_profile", {"num_bins": 8}),
    ("load_imbalance", {}),
    ("comm_matrix", {}),
    ("message_histogram", {"bins": 8}),
    ("stragglers", {"threshold": -1.0}),
    ("comm_over_time", {"num_bins": 16}),
    ("idle_time", {}),
    ("comm_by_process", {"output": "count"}),
    # thresholds of 0 report every rank, window or function with a cost
    ("late_sender", {"threshold": 0.0}),
    ("serialization", {}),
    ("imbalance_root_cause", {"threshold": 0.0}),
    ("efficiency_metrics", {"num_windows": 8}),
    ("pop_efficiency", {"threshold": 0.0}),
    ("diagnose", {}),
]
IDS = [f"{op}-{i}" for i, (op, _) in enumerate(FOLDS)]
#: the calls whose fold launches a kernel once a chunk that holds records
#: (``diagnose`` through ``stragglers``' fold)
KERNEL_FOLDS = FOLDS[:7] + FOLDS[-1:]
#: the host folds: no launch at all
HOST_FOLDS = FOLDS[7:-1]
#: ops the reference streams without a ``backend=`` argument
NO_BACKEND = {op for op, _ in HOST_FOLDS} | {"diagnose"}
#: the one fold whose state grows with the trace: the message instants
#: the late-receiver median needs (and ``diagnose``'s, through it)
GROWS = {"late_sender", "diagnose"}
CHUNKS = [61, 97, 4_999]
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """name -> paths: the straggler pathology trace as one jsonl file, a
    small ``big_trace`` as four per-rank jsonl shards, and the same as
    four pack shards."""
    d = tmp_path_factory.mktemp("fold")
    tr, _gt = tg.pathology_trace("straggler", nprocs=4, iters=24,
                                 magnitude=2.0, seed=11)
    one = str(d / "straggler.jsonl")
    write_jsonl(to_port(tr), one)
    kw = dict(nprocs=4, events_per_proc=1500, calls_per_iter=40, seed=3)
    return {"straggler": [one],
            "big_trace": big_trace(str(d / "big"), **kw),
            "pack": big_trace(str(d / "pack"), format="pack", **kw)}


def _src(paths):
    return paths if len(paths) > 1 else paths[0]


def _fold(paths, chunk_rows=97, **kw):
    return Trace.open(_src(paths), streaming=True, chunk_rows=chunk_rows,
                      device="cpu", fold="chunks", cache=False, **kw)


def _reference(paths, chunk_rows, op, kw):
    ref_kw = kw if op in NO_BACKEND else dict(kw, backend="numpy")
    return RefTrace.open(_src(paths), streaming=True,
                         chunk_rows=chunk_rows).query().run(
        op, cache=False, **ref_kw)


# ---------------------------------------------------------------------------
# the fold against the eager route and the reference's numpy route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op,kw", FOLDS, ids=IDS)
@pytest.mark.parametrize("chunk_rows", CHUNKS)
@pytest.mark.parametrize("name", ["straggler", "big_trace"])
def test_fold_within_the_gate_of_eager_and_reference(files, name,
                                                     chunk_rows, op, kw):
    paths = files[name]
    got = _fold(paths, chunk_rows).run(op, **kw)
    eager = Trace.open(_src(paths), device="cpu").run(op, **kw)
    op_gate(op, got, eager)
    op_gate(op, got, _reference(paths, chunk_rows, op, kw))


@pytest.mark.parametrize("op,kw", FOLDS, ids=IDS)
def test_fold_is_the_same_bits_on_relaunch(files, op, kw):
    paths = files["big_trace"]
    assert digest(_fold(paths, 61).run(op, **kw)) == \
        digest(_fold(paths, 61).run(op, **kw))


@pytest.mark.parametrize("op,kw", KERNEL_FOLDS,
                         ids=IDS[:7] + IDS[-1:])
def test_one_fold_a_chunk_that_holds_records(files, op, kw):
    """Each chunk with records is folded once (one launch), and only
    those: for the send ops, the chunks holding an ``MpiSend`` row;
    ``diagnose`` folds each chunk once, through ``stragglers``."""
    paths = files["big_trace"]
    st = _fold(paths, 211)
    chunks = list(st.iter_chunks())
    before = port_streaming.FOLDED_CHUNKS
    st.run(op, **kw)
    folded = port_streaming.FOLDED_CHUNKS - before
    if op in ("comm_matrix", "message_histogram"):
        assert folded == sum(bool(c.cat(NAME).mask_eq(MPI_SEND).any())
                             for c in chunks)
    else:
        # every chunk of 211 rows of this trace completes a call
        assert folded == len(chunks)


@pytest.mark.parametrize("op,kw", HOST_FOLDS, ids=IDS[7:-1])
def test_host_folds_launch_nothing(files, op, kw, monkeypatch):
    """The host ops fold in NumPy: no kernel wrapper is called, serially
    or over work units, and no chunk counts as a launch."""
    from repro_torch.core import accel, ops_summary

    def refuse(*a, **k):
        raise AssertionError(f"{op}: a kernel wrapper was called")

    for name in ("seg_sum", "pair_sum", "hist_counts"):
        monkeypatch.setattr(accel, name, refuse)
    monkeypatch.setattr(ops_summary, "_kernel_profile", refuse)
    before = port_streaming.FOLDED_CHUNKS
    paths = files["big_trace"]
    _fold(paths, 211).run(op, **kw)
    h = StreamingTrace(paths, chunk_rows=211, device="cpu", processes=2,
                       fold="chunks")
    spec = registry.get_op(op)
    kw_dev = dict(kw, device="cpu")
    executor.execute_parallel(h, (), spec, (), kw_dev,
                              port_streaming.make_agg(op, spec.streaming, (),
                                                      kw_dev, "chunks"),
                              n_units=3, use_pool=False)
    assert port_streaming.FOLDED_CHUNKS == before


def test_fold_over_pack_shards_and_a_plan(files):
    """The pack route and a plan (filter, ranks) fold as the jsonl one."""
    from repro_torch.core import Filter
    jsonl, pack = files["big_trace"], files["pack"]
    for op, kw in FOLDS:
        op_gate(op, _fold(pack).run(op, **kw),
                Trace.open(jsonl, device="cpu").run(op, **kw))

    def plan(q):
        return (q.filter(Filter(NAME, "not-in", ["halo_exchange()"]))
                .restrict_processes(range(4)))

    eager = plan(Trace.open(jsonl, device="cpu").query()).collect()
    for op, kw in FOLDS:
        op_gate(op, plan(_fold(pack).query()).run(op, **kw),
                eager.run(op, **kw))


def test_comm_matrix_fold_wraps_negative_partners(tmp_path):
    """A partner of -k lands in column n - k as in memory, though n is
    known only at the end; a partner outside a restricted selection
    raises the in-memory op's IndexError."""
    from repro_torch.core.constants import (ET, INSTANT, MSG_SIZE, PARTNER,
                                            PROC, TS)
    from repro_torch.core.frame import EventFrame
    rng = np.random.default_rng(0)
    n = 200
    ev = EventFrame({
        TS: np.arange(n, dtype=np.int64), ET: np.full(n, INSTANT, object),
        NAME: np.full(n, MPI_SEND, object),
        PROC: np.repeat(np.arange(4), n // 4).astype(np.int64),
        PARTNER: rng.choice([-2, -1, 0, 1, 2, 3], n).astype(np.int64),
        MSG_SIZE: rng.integers(1, 100, n).astype(np.float64)})
    path = str(tmp_path / "neg.jsonl")
    write_jsonl(Trace.from_events(ev, device="cpu"), path)
    eager = Trace.open(path, device="cpu")
    for chunk_rows in (7, 31):
        op_gate("comm_matrix", _fold([path], chunk_rows).comm_matrix(),
                eager.comm_matrix())
    with pytest.raises(IndexError):
        eager.query().restrict_processes([0, 1]).collect().comm_matrix()
    with pytest.raises(IndexError, match="process range"):
        _fold([path], 7).query().restrict_processes([0, 1]).comm_matrix()


# ---------------------------------------------------------------------------
# the statistics pre-pass
# ---------------------------------------------------------------------------

STAT_FIELDS = ("n_events", "ts_min", "ts_max", "proc_max", "size_min",
               "size_max", "n_sends")


def _same_stats(got, want):
    for f in STAT_FIELDS:
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("name", ["straggler", "big_trace"])
def test_stats_equal_the_reference(files, name):
    paths = files[name]
    got = Trace.open(_src(paths), streaming=True, chunk_rows=97,
                     device="cpu").stats()
    want = RefTrace.open(_src(paths), streaming=True,
                         chunk_rows=97).stats()
    assert isinstance(want, ref_streaming.StreamStats)
    _same_stats(got, want)


@pytest.mark.parametrize("n_units", [2, 7])
def test_parallel_stats_equal_the_reference(files, n_units):
    """The pre-pass over work units, merged in unit order, is the
    reference's serial stats (the partials merge exactly)."""
    paths = files["big_trace"]
    h = StreamingTrace(paths, chunk_rows=61, device="cpu", processes=2)
    got = executor.parallel_stats(h, (), n_units=n_units, use_pool=False)
    _same_stats(got, RefTrace.open(paths, streaming=True,
                                   chunk_rows=61).stats())


def test_stats_merge_is_exact():
    a, b = port_streaming.StreamStats(), port_streaming.StreamStats()
    a.n_events, a.ts_min, a.ts_max, a.proc_max = 3, 5.0, 9.0, 1
    b.n_events, b.ts_min, b.ts_max, b.proc_max = 4, 2.0, 7.0, 3
    b.n_sends, b.size_min, b.size_max = 2, 8.0, 64.0
    a.merge(b)
    assert (a.n_events, a.ts_min, a.ts_max, a.proc_max, a.n_sends,
            a.size_min, a.size_max) == (7, 2.0, 9.0, 3, 2, 8.0, 64.0)


# ---------------------------------------------------------------------------
# the parallel fold
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op,kw", FOLDS, ids=IDS)
@pytest.mark.parametrize("n_units", [2, 7])
def test_parallel_fold_agrees_with_serial(files, n_units, op, kw):
    """Units folded in-process (workers hold each chunk's records, the
    parent folds them as each unit arrives): within the gate of the
    serial fold, on shards and on one file whose byte spans cut calls."""
    for name in ("big_trace", "straggler"):
        paths = files[name]
        h = StreamingTrace(paths, chunk_rows=61, device="cpu", processes=2,
                           fold="chunks")
        spec = registry.get_op(op)
        kw_dev = dict(kw, device="cpu")
        agg = port_streaming.make_agg(op, spec.streaming, (), kw_dev,
                                      "chunks")
        got = executor.execute_parallel(h, (), spec, (), kw_dev, agg,
                                        n_units=n_units, use_pool=False)
        op_gate(op, got, _fold(paths, 61).run(op, **kw))


_SCRIPT = """
import sys, warnings
sys.path.insert(0, {src!r})
from repro_torch import Trace
from repro_torch.launch.cardcheck import op_gate


def main():
    warnings.simplefilter("error", RuntimeWarning)  # no degradation
    st = Trace.open({paths!r}, streaming=True, chunk_rows=211,
                    processes=2, device="cpu", fold="chunks", cache=False)
    serial = Trace.open({paths!r}, streaming=True, chunk_rows=211,
                        device="cpu", fold="chunks", cache=False)
    for op, kw in {ops!r}:
        op_gate(op, st.run(op, **kw), serial.run(op, **kw))
        assert len(st.units_cuda) >= 2, st.units_cuda
        assert not any(st.units_cuda), st.units_cuda
    pool = st._pool
    assert pool is not None and pool._pool is not None
    pool.close()
    print("POOLED", len(st.units_cuda))


if __name__ == "__main__":
    main()
"""


def test_parallel_fold_in_a_spawn_pool(files, tmp_path):
    """A real two-worker pool from a script on disk: the pooled fold,
    its pre-pass over the pool too, within the gate of the serial fold,
    and no worker initializes CUDA."""
    script = tmp_path / "run_fold_pool.py"
    script.write_text(textwrap.dedent(_SCRIPT.format(
        src=SRC, paths=files["big_trace"], ops=FOLDS)))
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("POOLED"), out.stdout


# ---------------------------------------------------------------------------
# live: fold only the new rows
# ---------------------------------------------------------------------------

GROUP = 128


@pytest.fixture(scope="module")
def ranks():
    ev = big_events(nprocs=3, events_per_proc=900, calls_per_iter=30,
                    seed=5)
    procs = np.asarray(ev["Process"])
    return [ev.mask(procs == r) for r in range(3)]


def _append_rows(writers, frames, lo, hi):
    for w, f in zip(writers, frames):
        hi_r = min(hi, len(f))
        if hi_r > lo:
            w.append(f.take(np.arange(lo, hi_r)))
        w.commit()


@pytest.mark.parametrize("op,kw", FOLDS, ids=IDS)
def test_live_fold_folds_only_new_rows(tmp_path, ranks, op, kw):
    """Grow three append shards twice.  The incremental fold is within
    the gate of a cold fold at each watermark and is fed only the new
    rows' chunks; the stored state's bytes do not move with the growth
    (same names, same ranks), but ``late_sender``'s, which keeps every
    message; an op that needs the pre-pass (the POP pair, ``diagnose``)
    takes the full pass, counted apart from the incremental
    fallbacks."""
    writers = [PackWriter.open_append(str(tmp_path / f"rank_{r}.pack"),
                                      chunk_rows=GROUP, fsync=False)
               for r in range(len(ranks))]
    paths = [w.path for w in writers]
    third = (max(len(f) for f in ranks) // 3 // GROUP + 1) * GROUP
    _append_rows(writers, ranks, 0, third)
    lt = LiveTrace(paths, device="cpu", chunk_rows=97, fold="chunks")
    lt.run(op, **kw)
    needs_stats = port_streaming.make_agg(
        op, registry.get_op(op).streaming, (), dict(kw, device="cpu"),
        "chunks").needs_stats
    entries = list(plancache._LIVE.values())
    assert len(entries) == (0 if needs_stats else 1)
    nbytes = entries[0].agg.nbytes if entries else None
    fallbacks = port_streaming.INCREMENTAL_FALLBACKS
    stats_passes = port_streaming.LIVE_STATS_PASSES
    for k in (1, 2):
        _append_rows(writers, ranks, k * third, (k + 1) * third)
        lt.refresh()
        fed = []
        if entries:
            # count the chunks the stored state is fed (host folds launch
            # nothing, so FOLDED_CHUNKS cannot count them)
            (entry,) = plancache._LIVE.values()
            entry.agg.update = (lambda chunk, update=entry.agg.update:
                                (fed.append(1), update(chunk)))
        folded = port_streaming.FOLDED_CHUNKS
        inc = lt.run(op, **kw)
        new = port_streaming.FOLDED_CHUNKS - folded
        cold = LiveTrace(paths, device="cpu", chunk_rows=97, cache=False,
                         fold="chunks").run(op, **kw)
        op_gate(op, inc, cold)
        op_gate(op, inc, lt.materialize().run(op, **kw))
        if entries:
            (entry,) = plancache._LIVE.values()
            if op in GROWS:
                assert entry.agg.nbytes > nbytes
                nbytes = entry.agg.nbytes
            else:
                assert entry.agg.nbytes == nbytes
            # only the new rows' chunks were folded: fewer than a full
            # pass over every committed row, one launch each where the
            # fold launches
            full = sum(-(-min(len(f), (k + 1) * third) // 97) for f in ranks)
            assert 0 < len(fed) < full
            if (op, kw) in KERNEL_FOLDS:
                assert 0 < new <= len(fed)
            else:
                assert new == 0
    assert port_streaming.INCREMENTAL_FALLBACKS == fallbacks
    assert port_streaming.LIVE_STATS_PASSES == stats_passes + (
        2 if needs_stats else 0)


# ---------------------------------------------------------------------------
# bounded memory
# ---------------------------------------------------------------------------

def _peak(run) -> int:
    tracemalloc.start()
    try:
        run()
        return tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()


#: events a rank of the short and the 4x longer trace
LENGTHS = (6_000, 24_000)


@pytest.fixture(scope="module")
def lengths(tmp_path_factory):
    """events a rank -> four pack shards of ``big_trace`` (the same names
    and ranks at both lengths)."""
    d = tmp_path_factory.mktemp("lengths")
    return {n: big_trace(str(d / str(n)), nprocs=4, events_per_proc=n,
                         calls_per_iter=40, seed=3, format="pack")
            for n in LENGTHS}


def _fold_state_bytes(paths, op, kw) -> int:
    """The ``nbytes`` of ``op``'s fold state after one pass over
    ``paths``."""
    h = StreamingTrace(paths, chunk_rows=2_000, device="cpu", fold="chunks",
                       cache=False)
    agg = port_streaming.make_agg(op, registry.get_op(op).streaming, (),
                                  dict(kw, device="cpu"), "chunks")
    agg.begin(h.stats() if agg.needs_stats else None)
    port_streaming.fold_frames(h.iter_chunks(), agg,
                               port_streaming.GlobalNames(),
                               port_streaming.CallStitcher())
    return agg.nbytes


def test_state_and_peak_do_not_grow_with_the_trace(lengths):
    """A trace 4x longer (same names, same ranks): the fold's state bytes
    are equal and its traced peak rises < 1.25x, while the buffering
    route's peak rises >= 2x."""
    peaks, nbytes = {}, {}
    kw = {"metrics": ("time.exc", "time.inc")}
    for n in LENGTHS:
        for fold in ("chunks", "once"):
            h = StreamingTrace(lengths[n], chunk_rows=2_000, device="cpu",
                               fold=fold, cache=False)
            h.run("flat_profile", **kw)       # warm imports and caches
            peaks[fold, n] = _peak(lambda: h.run("flat_profile", **kw))
        nbytes[n] = _fold_state_bytes(lengths[n], "flat_profile", kw)
    assert nbytes[6_000] == nbytes[24_000]
    assert peaks["chunks", 24_000] < 1.25 * peaks["chunks", 6_000], peaks
    assert peaks["once", 24_000] >= 2 * peaks["once", 6_000], peaks


@pytest.mark.parametrize("op,kw", FOLDS[1:], ids=IDS[1:])
def test_fold_state_does_not_grow_with_the_trace(lengths, op, kw):
    """Every fold's state on a 4x longer trace: the same bytes (sized by
    names, ranks, threads, windows or bins), but ``late_sender``'s (and
    ``diagnose``'s through it), which keeps each message's instants, as
    the reference's does: more bytes."""
    short, long_ = (_fold_state_bytes(lengths[n], op, kw) for n in LENGTHS)
    if op in GROWS:
        assert long_ > short
    else:
        assert long_ == short


# ---------------------------------------------------------------------------
# what cannot fold, and the handle's option
# ---------------------------------------------------------------------------

#: ops with no streaming form at all: they need the whole trace
EAGER_ONLY = ["comm_comp_breakdown", "calculate_lateness",
              "critical_path_analysis"]


@pytest.mark.parametrize("op", EAGER_ONLY)
def test_ops_with_no_streaming_form_still_refuse_a_fold(files, op):
    with pytest.raises(StreamingUnsupported, match=r"\.collect\(\)"):
        _fold(files["big_trace"]).run(op)


def test_an_aggregator_without_a_fold_form_names_fold_once():
    """An aggregator registered without a ``fold_form`` (a user's own op)
    runs with ``fold="once"`` and refuses ``"chunks"`` by name."""
    class Buffering(port_streaming.StreamAgg):
        pass

    assert isinstance(port_streaming.make_agg("mine", Buffering, (), {}),
                      Buffering)
    with pytest.raises(StreamingUnsupported, match='fold="once"'):
        port_streaming.make_agg("mine", Buffering, (), {}, "chunks")


def test_fold_is_a_streaming_option(files):
    path = files["straggler"][0]
    with pytest.raises(ValueError, match="fold only applies"):
        Trace.open(path, device="cpu", fold="chunks")
    with pytest.raises(ValueError, match="fold must be"):
        Trace.open(path, streaming=True, device="cpu", fold="all")
    st = Trace.open(path, streaming=True, device="cpu", fold="chunks")
    assert st.fold == "chunks"
    assert st.query().restrict_processes([0]).flat_profile() is not None
    assert st.with_steps(()).fold == "chunks"
    assert Trace.open(path, streaming=True, device="cpu").fold == "once"


def test_cache_keys_differ_by_fold(files):
    """A result of one mode never answers the other: the plan-result key
    and the live key both carry ``fold``."""
    from repro_torch.core.query import _StreamSource
    paths = files["pack"]
    spec = registry.get_op("flat_profile")
    kw = {"device": "cpu"}
    keys = {fold: plancache.plan_key(
        _StreamSource(StreamingTrace(paths, device="cpu", fold=fold)), (),
        spec, (), kw, None) for fold in ("once", "chunks")}
    assert None not in keys.values() and keys["once"] != keys["chunks"]
    live = {fold: plancache.live_plan_key(
        LiveTrace(paths, device="cpu", fold=fold), (), spec, (), kw)
        for fold in ("once", "chunks")}
    assert live["once"] != live["chunks"]
    # with the cache on, each mode computes its own result
    folded = Trace.open(paths, streaming=True, device="cpu",
                        fold="chunks").flat_profile()
    once = Trace.open(paths, streaming=True, device="cpu").flat_profile()
    assert once is not folded
    assert digest(once) == digest(Trace.open(paths, device="cpu")
                                  .flat_profile())
