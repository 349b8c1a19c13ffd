"""The reference's documented extension examples, run on the port.

Each example is defined once (:func:`register_examples`) and registered in
both packages with the same body; only the import differs, and on the CPU
the example reader builds its trace with ``device="cpu"``:

* ``busiest_function`` (``examples/quickstart.py``), through
  ``EventFrame.groupby_agg``;
* ``my_analysis(trace, **kwargs)`` (``docs/api.md``);
* the ``gpu_idle`` detector (``docs/diagnostics.md``), which calls the
  built-in ``idle_time`` inside it;
* the ``iteration_count_delta`` set op (``docs/comparing-traces.md``);
* a device-less reader ``read_myfmt(path, label=None)`` registered with
  ``iter_chunks=`` (a ``.myfmt`` file is an ``.npz`` of a frame's
  columns), and the same reader with no chunked form;
* ``enter_counts``, an op with a ``register_streaming`` aggregator
  written to ``docs/streaming.md``'s contract (:class:`_EnterCounts`).

None of them takes ``device``.  Each runs on the port's eager, lazy,
streamed (``fold="once"``, and ``"chunks"`` where the op has a fold form),
parallel and served routes, and gives the reference's result: host
results exactly, kernel-backed ones within ``cardcheck.op_gate``.  An op
that declares ``device`` still gets it.  The last test holds one case for
each fault the port had against these examples (each raised
``TypeError`` or ``AttributeError`` before the repair).
"""

import asyncio
import importlib
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro import tracegen as rtg
from repro.core import detectors as ref_detectors
from repro.core import plancache as ref_plancache
from repro.core import registry as ref_registry
from repro.core import streaming as ref_streaming
from repro.core.diff import TraceSet as RefTraceSet
from repro.core.filters import Filter as RefFilter
from repro.core.trace import Trace as RefTrace
from repro.serving.tracequery import TraceService as RefTraceService
from repro_torch.core import detectors, executor, registry, streaming
from repro_torch.core.constants import ENTER, ET, EXC, INC, NAME, PROC, TS
from repro_torch.core.diff import TraceSet
from repro_torch.core.filters import Filter
from repro_torch.core.frame import Categorical, EventFrame
from repro_torch.core.streaming import StreamingTrace, StreamingUnsupported
from repro_torch.core.trace import Trace
from repro_torch.launch.cardcheck import digest, op_gate
from repro_torch.readers.jsonl import iter_chunks_jsonl
from repro_torch.readers.pack import write_pack
from repro_torch.serving import protocol
from repro_torch.serving.tracequery import TraceService
from repro_torch.tracegen import big_trace

from test_torch_detectors import assert_findings_match
from test_torch_ops import fresh_plan_cache  # noqa: F401
from test_torch_ops import to_port
from test_torch_tracequery import payload, run, set_payload

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

USER_OPS = ["busiest_function", "my_analysis", "gpu_idle",
            "iteration_count_delta", "enter_counts", "device_seen"]
BUILTIN_DETECTORS = ["imbalance_root_cause", "late_sender", "pop_efficiency",
                     "serialization", "stragglers"]


# ---------------------------------------------------------------------------
# the examples, defined once for both packages
# ---------------------------------------------------------------------------

def _frame_columns(path):
    """A ``.myfmt`` file's frame as (name, values, categories or None)."""
    with np.load(path, allow_pickle=False) as z:
        names = [str(n) for n in z["columns"]]
        return [(n, z[f"v{i}"], z[f"c{i}"] if f"c{i}" in z.files else None)
                for i, n in enumerate(names)]


def write_myfmt(frame, path) -> str:
    """Store ``frame`` (of either package) as a ``.myfmt`` file: each
    column's values, and a categorical column's category table."""
    arrays = {"columns": np.asarray(frame.columns)}
    for i, c in enumerate(frame.columns):
        col = frame.column(c)
        if hasattr(col, "codes"):
            arrays[f"v{i}"] = np.asarray(col.codes)
            arrays[f"c{i}"] = np.asarray(col.categories).astype(str)
        else:
            arrays[f"v{i}"] = np.asarray(col)
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    return path


class _EnterCounts:
    """``enter_counts``' streaming form, to docs/streaming.md's contract:
    ``update`` folds each chunk, ``merge_from`` adds a later work unit's
    state through its name-code map, ``result`` gives the eager op's
    value.  It takes no ``device``."""

    supports_parallel = True

    def __init__(self):
        self.counts = np.zeros(0, np.int64)

    def _grow(self, n):
        if n > len(self.counts):
            self.counts = np.concatenate(
                [self.counts, np.zeros(n - len(self.counts), np.int64)])

    def update(self, chunk):
        ev = chunk.events
        codes = np.asarray(chunk.gcodes)[ev.cat(ET).mask_eq(ENTER)]
        if codes.size:
            self._grow(int(codes.max()) + 1)
            np.add.at(self.counts, codes, 1)

    def merge_from(self, other, code_map):
        if len(other.counts):
            mapped = np.asarray(code_map)[:len(other.counts)]
            self._grow(int(mapped.max()) + 1)
            np.add.at(self.counts, mapped, other.counts)

    def result(self, ctx):
        names = ctx.names.names
        return dict(sorted((names[i], int(c))
                           for i, c in enumerate(self.counts) if c))


class RefEnterCounts(_EnterCounts, ref_streaming.StreamAgg):
    pass


class PortEnterCounts(_EnterCounts, streaming.StreamAgg):
    pass


def register_examples(pkg: str, agg, trace_kw: dict) -> None:
    """Register every example in package ``pkg`` (``"repro"`` or
    ``"repro_torch"``): the same bodies, the package's own classes."""
    core = importlib.import_module(pkg + ".core")

    @core.register_op("busiest_function", needs_structure=True)
    def busiest_function(trace, metric=EXC):
        """Name of the function with the largest total exclusive time."""
        ev = trace.events
        ent = ev.mask(ev.cat(ET).mask_eq(ENTER))
        prof = ent.groupby_agg(NAME, {metric: "sum"})
        vals = np.nan_to_num(np.asarray(prof[metric], np.float64))
        return str(prof[NAME][int(np.argmax(vals))])

    @core.register_op("my_analysis", needs_structure=True)
    def my_analysis(trace, **kwargs):
        """Calls and longest inclusive time of the most-called functions."""
        ev = trace.events
        ent = ev.mask(ev.cat(ET).mask_eq(ENTER))
        prof = ent.groupby_agg(NAME, {INC: "max"}, count_name="calls")
        rows = sorted(zip(np.asarray(prof[NAME]).astype(str).tolist(),
                          np.asarray(prof["calls"]).tolist(),
                          np.asarray(prof[INC], np.float64).tolist()),
                      key=lambda r: (-r[1], r[0]))
        return rows[:kwargs.get("top", 3)]

    @core.register_detector("gpu_idle", category="efficiency",
                            threshold=0.25)
    def gpu_idle(trace, threshold=0.25):
        """Flags ranks whose idle share exceeds the threshold."""
        ev = trace.events
        ts = np.asarray(ev[TS], np.float64)
        procs = np.asarray(ev[PROC], np.int64)
        idle = trace.idle_time()
        rows = []
        for rank, spent in zip(np.asarray(idle[PROC]).tolist(),
                               np.asarray(idle["idle_time"]).tolist()):
            on = ts[procs == rank]
            t0, t1 = float(on.min()), float(on.max())
            frac = spent / (t1 - t0) if t1 > t0 else 0.0
            if frac >= threshold:
                rows.append({
                    "detector": "gpu_idle", "location": f"rank {rank}",
                    "process": rank, "function": "", "severity": frac,
                    "t_start": t0, "t_end": t1,
                    "explanation": f"rank {rank} idle {frac:.0%} of the run",
                })
        return core.Findings(rows)

    @core.register_op("iteration_count_delta", needs_structure=True,
                      scope="set")
    def iteration_count_delta(traces, marker="time-loop"):
        """Change in detected iteration count between first and last run."""
        def count(t):
            ev = t.events
            m = ev.cat("Name").mask_eq(marker) & \
                ev.cat("Event Type").mask_eq("Enter")
            return int(np.count_nonzero(m))
        return count(traces[-1]) - count(traces[0])

    def load_frame(path):
        frame = core.EventFrame()
        for name, vals, cats in _frame_columns(path):
            frame[name] = (vals if cats is None
                           else core.Categorical(vals, cats))
        return frame

    def read_myfmt(path, label=None):
        return core.Trace(load_frame(path), label=label or path, **trace_kw)

    def iter_myfmt(path, chunk_rows, hints=None, **kw):
        ev = load_frame(path)
        for lo in range(0, len(ev), chunk_rows):
            yield ev.take(np.arange(lo, min(lo + chunk_rows, len(ev))))

    core.register_reader("myfmt", extensions=(".myfmt",),
                         iter_chunks=iter_myfmt)(read_myfmt)
    core.register_reader("myfmt_whole")(read_myfmt)

    @core.register_op("enter_counts")
    def enter_counts(trace):
        """Enter events by function name."""
        ev = trace.events
        names = ev[NAME][ev.cat(ET).mask_eq(ENTER)]
        keys, counts = np.unique(np.asarray(names).astype(str),
                                 return_counts=True)
        return dict(zip(keys.tolist(), counts.tolist()))

    core.register_streaming("enter_counts")(agg)

    @core.register_op("device_seen")
    def device_seen(trace, device=None):
        """The device the port handed over (an op that declares one)."""
        return str(device)


def _unregister(reg, dets) -> None:
    for name in USER_OPS:
        reg._OP_REGISTRY.pop(name, None)
    for name in ("myfmt", "myfmt_whole"):
        reg._READER_REGISTRY.pop(name, None)
    dets._DETECTOR_REGISTRY.pop("gpu_idle", None)


@pytest.fixture(scope="module")
def examples():
    register_examples("repro", RefEnterCounts, {})
    register_examples("repro_torch", PortEnterCounts, {"device": "cpu"})
    yield
    _unregister(ref_registry, ref_detectors)
    _unregister(registry, detectors)


# ---------------------------------------------------------------------------
# traces and files
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def patho(examples):
    """Game of Life on 4 ranks with rank 0 given 80 % more work: ranks
    1-3 idle 35-43 % of the run (past ``gpu_idle``'s threshold), and the
    built-in detectors fire too."""
    ref = rtg.gol(nprocs=4, iters=8, imbalance=0.8, seed=3)
    return ref, to_port(ref)


@pytest.fixture(scope="module")
def files(tmp_path_factory, patho):
    """jsonl shards of a small ``big_trace`` and the same frames (in file
    order) as ``.myfmt`` shards; the pathology as a pack and a
    ``.myfmt`` file; two baselines of 12 and 16 iterations as packs."""
    d = tmp_path_factory.mktemp("ext")
    jsonl = big_trace(str(d / "big"), nprocs=4, events_per_proc=600,
                      calls_per_iter=40, seed=11)
    mine = []
    for p in jsonl:
        (frame,) = list(iter_chunks_jsonl(p, 1 << 30))
        mine.append(write_myfmt(frame, p[:-len(".jsonl")] + ".myfmt"))
    fresh = to_port(patho[0])
    one = write_myfmt(fresh.events, str(d / "patho.myfmt"))
    pack = write_pack(fresh, str(d / "patho.pack"))
    runs = [write_pack(to_port(rtg.baseline(nprocs=4, iters=n)),
                       str(d / f"base{n}.pack")) for n in (12, 16)]
    return {"jsonl": jsonl, "myfmt": mine, "pack": pack, "one": one,
            "runs": runs}


def _port(t, op, **kw):
    return t.run(op, **kw)


def _ref(t, op, **kw):
    return t.query().run(op, **kw)


def _same(op, got, want) -> None:
    if op == "gpu_idle":
        assert digest(got) == digest(want)
    else:
        assert got == want, op


TRACE_OPS = [("busiest_function", {}), ("busiest_function", {"metric": INC}),
             ("my_analysis", {}), ("my_analysis", {"top": 5}),
             ("gpu_idle", {}), ("gpu_idle", {"threshold": 0.0}),
             ("enter_counts", {})]
TRACE_IDS = [f"{op}-{i}" for i, (op, _) in enumerate(TRACE_OPS)]


# ---------------------------------------------------------------------------
# the registration records
# ---------------------------------------------------------------------------

def test_registration_records_whether_each_callable_takes_device(examples):
    for name in ("busiest_function", "gpu_idle", "iteration_count_delta",
                 "enter_counts"):
        assert registry.get_op(name).takes_device is False, name
    for name in ("my_analysis", "device_seen", "flat_profile", "diagnose",
                 "stragglers", "idle_time", "diff_flat_profile"):
        assert registry.get_op(name).takes_device is True, name
    assert registry.get_op("enter_counts").streaming_takes_device is False
    assert registry.get_op("flat_profile").streaming_takes_device is True
    for fmt in ("myfmt", "myfmt_whole"):
        assert registry.get_reader(fmt).read_takes_device is False
    assert registry.get_reader("jsonl").read_takes_device is True
    assert registry.get_reader("myfmt").iter_chunks is not None
    assert registry.get_reader("myfmt_whole").iter_chunks is None


def test_call_with_device_hands_device_only_where_it_is_taken():
    def bare(x, k=1):
        return (x, k)

    def named(x, device=None):
        return (x, device)

    def anykw(x, **kw):
        return (x, kw)

    def positional_only(x, device, /):
        return (x, device)

    call = registry.call_with_device
    assert call(bare, None, 1, k=2, device="cpu") == (1, 2)
    assert call(named, None, 1, device="cpu") == (1, "cpu")
    assert call(anykw, None, 1, device="cpu") == (1, {"device": "cpu"})
    assert not registry.takes_device(positional_only)
    assert call(named, False, 1, device="cpu") == (1, None)


# ---------------------------------------------------------------------------
# eager and lazy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op,kw", TRACE_OPS, ids=TRACE_IDS)
def test_eager_route_gives_the_references_result(patho, op, kw):
    ref, port = patho
    _same(op, _port(port, op, **kw), _ref(ref, op, **kw))


@pytest.mark.parametrize("op,kw", TRACE_OPS, ids=TRACE_IDS)
def test_lazy_plan_gives_the_references_result(patho, op, kw):
    ref, port = patho
    got = port.query().filter(Filter(PROC, "<", 3)).filter(
        Filter(NAME, "not-in", ["compute"])).run(op, **kw)
    want = ref.query().filter(RefFilter(PROC, "<", 3)).filter(
        RefFilter(NAME, "not-in", ["compute"])).run(op, **kw)
    _same(op, got, want)
    assert _same(op, getattr(port.query(), op)(**kw),
                 getattr(ref.query(), op)(**kw)) is None


def test_gpu_idle_fires_on_the_pathology(patho):
    ref, port = patho
    got = port.run("gpu_idle")
    assert len(got) >= 1 and set(got["detector"]) == {"gpu_idle"}


def test_an_op_that_declares_device_still_gets_it(patho):
    _ref_t, port = patho
    assert port.run("device_seen") == "cpu"
    assert port.query().device_seen() == "cpu"
    assert port.run("device_seen", device="cpu") == "cpu"
    # and a **kwargs op runs as the reference's, device among its kwargs
    assert port.run("my_analysis", top=2) == \
        _ref(_ref_t, "my_analysis", top=2)


def test_diagnose_with_a_user_detector_equals_the_references(patho):
    ref, port = patho
    got = port.diagnose()
    assert_findings_match(got, ref.diagnose(), "diagnose + gpu_idle")
    # the built-in findings unchanged, plus gpu_idle's
    built_in = port.diagnose(detectors=BUILTIN_DETECTORS)
    keep = np.asarray(got["detector"]) != "gpu_idle"
    assert digest(got.mask(keep)) == digest(built_in)
    mine = got.mask(~keep)
    assert len(mine) >= 1 and digest(
        detectors.Findings([{c: mine[c][i] for c in mine.columns}
                            for i in range(len(mine))])) == digest(
        port.run("gpu_idle"))


def test_streamed_diagnose_names_the_detector_without_a_streaming_form(
        files):
    for mod, T in ((streaming, Trace), (ref_streaming, RefTrace)):
        kw = {"device": "cpu"} if T is Trace else {}
        st = T.open(files["jsonl"], streaming=True, chunk_rows=97, **kw)
        with pytest.raises(mod.StreamingUnsupported, match="gpu_idle"):
            st.diagnose()


# ---------------------------------------------------------------------------
# the set op
# ---------------------------------------------------------------------------

def test_set_op_gives_the_references_result(files):
    ref = [RefTrace.open(p) for p in files["runs"]]
    port = [Trace.open(p, device="cpu") for p in files["runs"]]
    for marker in ("iteration", "compute"):
        want = RefTraceSet(ref).iteration_count_delta(marker=marker)
        assert want == 16
        assert TraceSet(port).iteration_count_delta(marker=marker) == want
        lazy = TraceSet(port).query().filter(Filter(PROC, "<", 2)).run(
            "iteration_count_delta", marker=marker)
        assert lazy == RefTraceSet(ref).query().filter(
            RefFilter(PROC, "<", 2)).run("iteration_count_delta",
                                          marker=marker) == 8
    assert TraceSet.open(files["runs"], device="cpu").run(
        "iteration_count_delta", marker="iteration", processes=2) == 16
    # a trace op mapped over the set
    assert TraceSet(port).run("busiest_function") == [
        _ref(t, "busiest_function") for t in ref]


# ---------------------------------------------------------------------------
# the reader
# ---------------------------------------------------------------------------

def test_user_reader_opens_eagerly_on_the_callers_device(files, patho):
    got = Trace.open(files["one"], device="cpu")
    assert got.device.type == "cpu" and got.label == files["one"]
    want = to_port(patho[0])
    assert digest(got.flat_profile()) == digest(want.flat_profile())
    ref = RefTrace.open(files["one"])
    for op in ("busiest_function", "my_analysis", "gpu_idle"):
        _same(op, _port(got, op), _ref(ref, op))
    op_gate("flat_profile", got.flat_profile(),
            ref.flat_profile(backend="numpy"))
    with pytest.raises(RuntimeError, match="CUDA"):
        Trace.open(files["one"])  # the card by default, and none here


@pytest.mark.parametrize("fold", ["once", "chunks"])
@pytest.mark.parametrize("fmt", ["myfmt", "myfmt_whole"])
def test_user_reader_streams_as_the_built_in_reader(files, fmt, fold):
    """Over the user's ``iter_chunks`` (or, with none, the whole-file
    fallback, a device-less ``read``), every chunk is the built-in
    reader's, so a streamed op gives its bits, with as many folds."""
    def flat(paths, **kw):
        before = streaming.FOLDED_CHUNKS
        out = StreamingTrace(paths, chunk_rows=97, device="cpu", fold=fold,
                             cache=False, **kw).flat_profile()
        return digest(out), streaming.FOLDED_CHUNKS - before

    got = flat(files["myfmt"], format=fmt)
    assert got == flat(files["jsonl"])
    if fold == "chunks":
        assert got[1] > 0


def test_user_reader_over_shards_and_work_units(files):
    eager = Trace.open(files["jsonl"], device="cpu").flat_profile()
    assert digest(Trace.open(files["myfmt"], device="cpu").flat_profile()) \
        == digest(eager)
    spec = registry.get_op("flat_profile")
    for n_units in (2, 3):
        for fmt in ("myfmt", "myfmt_whole"):
            h = StreamingTrace(files["myfmt"], format=fmt, chunk_rows=97,
                               device="cpu", processes=2)
            kw = {"device": "cpu"}
            got = executor.execute_parallel(h, (), spec, (), kw,
                                            spec.streaming(**kw),
                                            n_units=n_units, use_pool=False)
            assert digest(got) == digest(eager), (fmt, n_units)


def test_scan_skips_no_user_shard_and_reads_them(files):
    from repro_torch.core.query import scan
    got = scan(files["myfmt"], device="cpu").filter(
        Filter(PROC, "in", [1, 2])).flat_profile()
    want = Trace.open(files["jsonl"], device="cpu").query().filter(
        Filter(PROC, "in", [1, 2])).flat_profile()
    assert digest(got) == digest(want)


# ---------------------------------------------------------------------------
# the streaming aggregator
# ---------------------------------------------------------------------------

def test_user_aggregator_streams_as_the_reference(files):
    want = RefTrace.open(files["jsonl"], streaming=True, chunk_rows=97
                         ).query().run("enter_counts", cache=False)
    eager = Trace.open(files["jsonl"], device="cpu").run("enter_counts")
    assert eager == want
    st = StreamingTrace(files["jsonl"], chunk_rows=97, device="cpu")
    assert st.run("enter_counts", cache=False) == want
    assert st.query().filter(Filter(PROC, "<", 2)).run(
        "enter_counts", cache=False) == RefTrace.open(
        files["jsonl"], streaming=True, chunk_rows=97).query().filter(
        RefFilter(PROC, "<", 2)).run("enter_counts", cache=False)
    # over the user's reader too
    assert StreamingTrace(files["myfmt"], chunk_rows=61,
                          device="cpu").run("enter_counts") == want


@pytest.mark.parametrize("n_units", [2, 5])
def test_user_aggregator_merges_over_work_units(files, n_units):
    spec = registry.get_op("enter_counts")
    rspec = ref_registry.get_op("enter_counts")
    from repro.core import executor as ref_executor
    got = executor.execute_parallel(
        StreamingTrace(files["jsonl"], chunk_rows=97, device="cpu",
                       processes=2), (), spec, (), {"device": "cpu"},
        streaming.make_agg("enter_counts", spec.streaming, (),
                           {"device": "cpu"}),
        n_units=n_units, use_pool=False)
    want = ref_executor.execute_parallel(
        ref_streaming.StreamingTrace(files["jsonl"], chunk_rows=97,
                                     processes=2), (), rspec, (), {},
        rspec.streaming(), n_units=n_units, use_pool=False)
    assert spec.parallel_safe and got == want


def test_user_aggregator_without_a_fold_form_names_fold_once(files):
    st = StreamingTrace(files["jsonl"], chunk_rows=97, device="cpu",
                        fold="chunks")
    with pytest.raises(StreamingUnsupported, match='fold="once"'):
        st.run("enter_counts")


# ---------------------------------------------------------------------------
# served
# ---------------------------------------------------------------------------

def _decode(resp):
    return protocol.decode_value(json.loads(json.dumps(resp["result"])))


@pytest.mark.parametrize("source", ["pack", "one"])
def test_served_user_ops_give_the_references_result(files, source):
    path = files[source]
    ref = RefTrace.open(path)

    async def main():
        svc = TraceService(device="cpu")
        out = {}
        for op, kw in TRACE_OPS:
            out[(op, str(kw))] = await svc.query(payload([path], op,
                                                         kwargs=kw))
        out["diagnose"] = await svc.query(payload([path], "diagnose"))
        return out

    got = run(main())
    for op, kw in TRACE_OPS:
        _same(op, _decode(got[(op, str(kw))]), _ref(ref, op, **kw))
    assert_findings_match(_decode(got["diagnose"]), ref.diagnose(),
                          "served diagnose")


def test_served_set_op_and_streamed_aggregator(files):
    async def main():
        svc = TraceService(device="cpu")
        delta = await svc.query(set_payload(
            files["runs"], "iteration_count_delta",
            kwargs={"marker": "iteration"}), set_scope=True)
        counts = await svc.query(payload(files["myfmt"], "enter_counts",
                                         streaming=True))
        ref_plancache.clear()
        theirs = await RefTraceService().query(set_payload(
            files["runs"], "iteration_count_delta", cache=False,
            kwargs={"marker": "iteration"}), set_scope=True)
        return delta, counts, theirs

    delta, counts, theirs = run(main())
    assert _decode(delta) == 16 == theirs["result"]
    assert _decode(counts) == RefTrace.open(
        files["jsonl"], streaming=True).query().run("enter_counts",
                                                    cache=False)


# ---------------------------------------------------------------------------
# pool workers
# ---------------------------------------------------------------------------

_POOL_SCRIPT = textwrap.dedent('''
    import sys, warnings
    import numpy as np
    from repro_torch.core import Trace, register_op, register_streaming
    from repro_torch.core.constants import ENTER, ET
    from repro_torch.core.streaming import StreamAgg

    @register_op("enter_total")
    def enter_total(trace):
        return int(np.count_nonzero(trace.events.cat(ET).mask_eq(ENTER)))

    @register_streaming("enter_total")
    class EnterTotal(StreamAgg):
        supports_parallel = True

        def __init__(self):
            self.n = 0

        def update(self, chunk):
            self.n += int(np.count_nonzero(
                chunk.events.cat(ET).mask_eq(ENTER)))

        def merge_from(self, other, code_map):
            self.n += other.n

        def result(self, ctx):
            return self.n

    if __name__ == "__main__":
        paths = sys.argv[1:]
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            st = Trace.open(paths, streaming=True, processes=2,
                            chunk_rows=97, device="cpu", cache=False)
            got = st.enter_total()
        degraded = [str(x.message) for x in w
                    if "degraded to serial" in str(x.message)]
        serial = Trace.open(paths, device="cpu").run("enter_total")
        print(got, serial, len(degraded), st.units_cuda)
''')


def test_pool_workers_run_a_user_aggregator_registered_in_main(
        files, tmp_path):
    """From a script on disk the spawn pool runs: each worker re-imports
    ``__main__`` and its registrations, and the device-less factory folds
    every unit.  From ``python -c`` (a spawn-unsafe ``__main__``) the op
    degrades to the serial pass with the reference's warning."""
    script = tmp_path / "pool_ext.py"
    script.write_text(_POOL_SCRIPT)
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, str(script)] + files["jsonl"],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    got, serial, degraded, units = out.stdout.split(maxsplit=3)
    assert got == serial and degraded == "0"
    assert "True" not in units and "False" in units
    out = subprocess.run([sys.executable, "-c", _POOL_SCRIPT]
                         + files["jsonl"], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    got, serial, degraded, _units = out.stdout.split(maxsplit=3)
    assert got == serial and degraded == "1"


# ---------------------------------------------------------------------------
# each fault of the port against these examples, repaired
# ---------------------------------------------------------------------------
# Self-contained: each case registers what it needs under a name of its
# own and removes it, so each fails on its own fault alone.

def _fault_trace():
    return to_port(rtg.gol(nprocs=3, iters=3, seed=1))


def _fault_register_op(tmp_path):
    @registry.register_op("fault_busiest", needs_structure=True)
    def fault_busiest(trace, metric=EXC):
        return len(trace.events)
    try:
        t = _fault_trace()
        assert t.query().fault_busiest() == t.run("fault_busiest") == \
            len(t.events)
    finally:
        registry._OP_REGISTRY.pop("fault_busiest")


def _fault_groupby_agg(tmp_path):
    ev = _fault_trace().events
    assert len(ev.groupby_agg(NAME, {TS: "max"})) == len(
        set(np.asarray(ev[NAME]).tolist()))


def _fault_detector_breaks_diagnose(tmp_path):
    @detectors.register_detector("_fault_idle", category="efficiency",
                                 threshold=0.25)
    def _fault_idle(trace, threshold=0.25):
        """Never fires."""
        return detectors.Findings([])
    try:
        t = _fault_trace()
        assert digest(t.diagnose()) == digest(
            t.diagnose(detectors=BUILTIN_DETECTORS))
    finally:
        registry._OP_REGISTRY.pop("_fault_idle")
        detectors._DETECTOR_REGISTRY.pop("_fault_idle")


def _fault_set_op(tmp_path):
    @registry.register_op("fault_delta", scope="set")
    def fault_delta(traces, marker="main()"):
        return len(traces[-1].events) - len(traces[0].events)
    try:
        a, b = _fault_trace(), to_port(rtg.gol(nprocs=3, iters=5, seed=1))
        assert TraceSet([a, b]).fault_delta() == \
            len(b.events) - len(a.events)
    finally:
        registry._OP_REGISTRY.pop("fault_delta")


def _fault_reader_without_device(tmp_path):
    path = write_myfmt(_fault_trace().events, str(tmp_path / "t.faultfmt"))

    @registry.register_reader("_fault_fmt", extensions=(".faultfmt",))
    def _read(path, label=None):
        frame = EventFrame()
        for name, vals, cats in _frame_columns(path):
            frame[name] = vals if cats is None else \
                Categorical(vals, cats)
        return Trace(frame, label=label, device="cpu")
    try:
        t = Trace.open(path, device="cpu")
        assert t.device.type == "cpu" and len(t.events) == len(
            _fault_trace().events)
        with pytest.raises(RuntimeError, match="CUDA"):
            Trace.open(path)  # the card by default; none here
    finally:
        registry._READER_REGISTRY.pop("_fault_fmt")


def _fault_register_reader_iter_chunks(tmp_path):
    def chunks(path, chunk_rows, hints=None, **kw):
        return iter(())

    @registry.register_reader("_fault_chunked", iter_chunks=chunks)
    def _read(path, label=None):
        raise AssertionError("not read")
    try:
        assert registry.get_reader("_fault_chunked").iter_chunks is chunks
    finally:
        registry._READER_REGISTRY.pop("_fault_chunked")


def _fault_stragglers_keywords(tmp_path):
    t = _fault_trace()
    got = t.stragglers(cache=True, threshold=-1.0)
    assert digest(got) == digest(t.stragglers(threshold=-1.0))


def _fault_frame_methods(tmp_path):
    ev = EventFrame({"a": np.arange(3), NAME: ["x", "y", "x"]})
    assert ev.rename({"a": "b"}).columns == ["b", NAME]
    assert list(ev.to_dict()) == ["a", NAME]
    assert ev.to_csv().splitlines() == [f"a,{NAME}", "0,x", "1,y", "2,x"]


FAULTS = {"register_op": _fault_register_op,
          "groupby_agg": _fault_groupby_agg,
          "register_detector_diagnose": _fault_detector_breaks_diagnose,
          "set_op": _fault_set_op,
          "register_reader_read": _fault_reader_without_device,
          "register_reader_iter_chunks": _fault_register_reader_iter_chunks,
          "stragglers_keywords": _fault_stragglers_keywords,
          "frame_rename_to_dict_to_csv": _fault_frame_methods}


@pytest.mark.parametrize("case", sorted(FAULTS))
def test_fault_of_the_port_is_repaired(tmp_path, case):
    """One case a row of the faults found against the reference's
    extension contract: each raised ``TypeError`` (``device=`` handed to
    a callable that takes none; ``iter_chunks=`` and ``stragglers``'
    keywords refused) or ``AttributeError`` (the frame's methods)."""
    FAULTS[case](tmp_path)
