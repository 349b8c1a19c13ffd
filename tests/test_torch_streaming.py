"""The port's out-of-core route: ``Trace.open(..., streaming=True)``.

A jsonl trace streamed in chunks of 61 and 97 rows (sizes that split
enter/leave pairs and parent chains across chunk boundaries) must give,
for each of the six kernel-backed ops, the same bits as the port's
in-memory route on the same file: the same records reach the kernel in the
same canonical order.  It must also agree with the reference's streaming
route (``backend="pallas"``, interpret mode) within
``tests/test_torch_ops.py``'s tolerance.
"""

import numpy as np
import pytest
import torch

from repro import tracegen as tg
from repro.core.trace import Trace as RefTrace
from repro_torch import Trace
from repro_torch.core import (EventFrame, Filter, StreamingTrace,
                              StreamingUnsupported, registry)
from repro_torch.core.constants import EXC, NAME, PROC, TS
from repro_torch.core.streaming import CallStitcher, GlobalNames, grow_to
from repro_torch.launch.cardcheck import digest
from repro_torch.readers import jsonl, write_jsonl
from repro_torch.tracegen import big_trace

from test_torch_ops import OPS, assert_equivalent, to_port
from test_torch_stragglers import assert_findings

TERMINALS = OPS + [("stragglers", {"threshold": -1.0})]
IDS = [f"{op}-{i}" for i, (op, _) in enumerate(TERMINALS)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """name -> jsonl paths: the straggler pathology trace as one file, and
    a small ``big_trace`` as four per-rank shards."""
    d = tmp_path_factory.mktemp("stream")
    tr, _gt = tg.pathology_trace("straggler", nprocs=4, iters=24,
                                 magnitude=2.0, seed=11)
    one = str(d / "straggler.jsonl")
    write_jsonl(to_port(tr), one)
    shards = big_trace(str(d / "big"), nprocs=4, events_per_proc=1500,
                       calls_per_iter=40, seed=3)
    return {"straggler": [one], "big_trace": shards}


def _open(paths, **kw):
    return Trace.open(paths if len(paths) > 1 else paths[0], device="cpu",
                      **kw)


@pytest.mark.parametrize("op,kw", TERMINALS, ids=IDS)
@pytest.mark.parametrize("chunk_rows", [61, 97])
@pytest.mark.parametrize("name", ["straggler", "big_trace"])
def test_streaming_equals_eager_bit_for_bit(files, name, chunk_rows, op, kw):
    paths = files[name]
    st = _open(paths, streaming=True, chunk_rows=chunk_rows)
    assert isinstance(st, StreamingTrace)
    assert digest(st.run(op, **kw)) == digest(_open(paths).run(op, **kw))


@pytest.mark.parametrize("op,kw", TERMINALS, ids=IDS)
def test_streaming_matches_reference_streaming(files, op, kw):
    path = files["straggler"][0]
    got = Trace.open(path, streaming=True, chunk_rows=97,
                     device="cpu").run(op, **kw)
    want = RefTrace.open(path, streaming=True, chunk_rows=97).query().run(
        op, cache=False, backend="pallas", **kw)
    if op == "stragglers":
        assert_findings(got, want, op)
    else:
        assert_equivalent(op, got, want, context=op)


def _plan(q):
    return (q.filter(Filter(NAME, "not-in", ["halo_exchange()"]))
            .restrict_processes(range(3))
            .filter(Filter(TS, "between", (0, 4e9))))


@pytest.mark.parametrize("op,kw", TERMINALS, ids=IDS)
def test_streaming_plan_equals_eager_selection(files, op, kw):
    """A plan over the stream masks each chunk; the same selection made
    eagerly and then reduced gives the same bits."""
    paths = files["big_trace"]
    st = _open(paths, streaming=True, chunk_rows=97)
    eager = _plan(_open(paths).query()).collect()
    try:
        want = eager.run(op, **kw)
    except IndexError:
        with pytest.raises(IndexError):
            _plan(st.query()).run(op, **kw)
        return
    assert digest(_plan(st.query()).run(op, **kw)) == digest(want)


def test_handle_facts_and_materialize(files):
    paths = files["big_trace"]
    st = _open(paths, streaming=True, chunk_rows=97)
    eager = _open(paths)
    assert len(st) == len(eager)
    assert st.num_processes == eager.num_processes
    stats = st.stats()
    ts = np.asarray(eager.events[TS], np.float64)
    assert (stats.ts_min, stats.ts_max) == (ts.min(), ts.max())
    whole = st.materialize()
    assert whole.device == st.device == torch.device("cpu")
    assert len(whole) == len(eager)
    assert st.query().restrict_processes([0]).collect().device == st.device


@pytest.mark.parametrize("chunk_rows", [1, 7, 1000])
def test_chunked_reader_partitions_the_file(files, chunk_rows):
    path = files["straggler"][0]
    frames = list(jsonl.iter_chunks_jsonl(path, chunk_rows))
    assert all(len(f) <= chunk_rows for f in frames)
    whole = jsonl.read_jsonl(path, device="cpu").events
    names = GlobalNames()
    codes = np.concatenate([names.encode(f.cat(NAME)) for f in frames])
    got = np.asarray(names.names, dtype=object)[codes].astype(str)
    np.testing.assert_array_equal(got, whole[NAME])
    for c in (TS, PROC):
        np.testing.assert_array_equal(
            np.concatenate([np.asarray(f[c], np.int64) for f in frames]),
            np.asarray(whole[c], np.int64))


@pytest.mark.parametrize("cuts", [(0, 1), (1, 2), (3, 40, 41, 500)])
def test_byte_ranges_own_every_line_once(files, cuts):
    path = files["straggler"][0]
    size = len(open(path, "rb").read())
    edges = [0] + [c for c in cuts if 0 < c < size] + [size]
    parts = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        for f in jsonl.iter_chunks_jsonl(path, 50, byte_range=(lo, hi)):
            parts.append(np.asarray(f[TS], np.int64))
    whole = jsonl.read_jsonl(path, device="cpu").events
    np.testing.assert_array_equal(np.concatenate(parts),
                                  np.asarray(whole[TS], np.int64))


def test_tolerant_chunked_read_skips_and_counts(tmp_path):
    path = tmp_path / "bad.jsonl"
    path.write_text('{"ts": 0, "et": "Enter", "name": "f", "proc": 0}\n'
                    'not json\n'
                    '{"ts": 5, "et": "Leave", "name": "f", "proc": 0}\n')
    with pytest.raises(Exception, match="line 2"):
        list(jsonl.iter_chunks_jsonl(str(path), 2))
    st = Trace.open(str(path), streaming=True, chunk_rows=2, device="cpu",
                    on_error="skip")
    prof = st.flat_profile()
    assert np.asarray(prof["count"]).tolist() == [1]
    assert st.ingest_report().total_skipped() == 1


def test_format_without_a_chunked_reader_streams_a_whole_read(files,
                                                              tmp_path):
    """A format with no ``iter_chunks`` streams its whole-file read cut
    into chunks: the same bits."""
    registry.register_reader("jsonl_whole")(jsonl.read_jsonl)
    try:
        path = tmp_path / "t.jsonl"
        path.write_bytes(open(files["straggler"][0], "rb").read())
        st = Trace.open(str(path), format="jsonl_whole", streaming=True,
                        chunk_rows=61, device="cpu")
        assert registry.get_reader("jsonl_whole").iter_chunks is None
        want = _open(files["straggler"])
        for op, kw in TERMINALS:
            assert digest(st.run(op, **kw)) == digest(want.run(op, **kw))
    finally:
        registry._READER_REGISTRY.pop("jsonl_whole")


def test_op_without_a_streaming_form_raises(files):
    @registry.register_op("count_rows_eagerly")
    def count_rows_eagerly(trace, device="cuda"):
        return len(trace)

    try:
        st = _open(files["straggler"], streaming=True, chunk_rows=97)
        with pytest.raises(StreamingUnsupported, match=r"\.collect\(\)"):
            st.count_rows_eagerly()
        assert st.materialize().run("count_rows_eagerly") == len(st)
    finally:
        registry._OP_REGISTRY.pop("count_rows_eagerly")


def test_plans_streaming_cannot_run_raise(files):
    st = _open(files["straggler"], streaming=True, chunk_rows=97)
    with pytest.raises(StreamingUnsupported, match="overlap"):
        st.query().slice_time(0, 1e9).flat_profile()
    with pytest.raises(StreamingUnsupported, match="derived"):
        st.query().filter(Filter(EXC, ">", 0)).flat_profile()
    with pytest.raises(StreamingUnsupported, match="metrics"):
        st.flat_profile(metrics=("_msg_size",))


def test_unsorted_stream_raises():
    ev = EventFrame({TS: np.asarray([5, 3], np.int64),
                     "Event Type": np.asarray(["Enter", "Leave"]),
                     NAME: np.asarray(["f", "f"]),
                     PROC: np.asarray([0, 0], np.int64)})
    with pytest.raises(StreamingUnsupported, match="time order"):
        CallStitcher().push_chunk(ev, np.zeros(2, np.int64))


def test_grow_to_keeps_values_and_fill():
    a = grow_to(np.arange(3), (5,), fill=-1)
    assert a.tolist() == [0, 1, 2, -1, -1, -1]
    b = np.zeros((2, 2))
    assert grow_to(b, (1, 2)) is b


@pytest.mark.parametrize("kw", [{"processes": 2}, {"executor": "parallel"},
                                {"live": True}],
                         ids=["processes", "parallel", "live"])
def test_parallel_and_live_are_not_yet_ported(files, kw):
    with pytest.raises(NotImplementedError, match=r"ROADMAP §A\.3"):
        _open(files["straggler"], streaming=True, **kw)


def test_streaming_handle_defaults_to_the_card(files):
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trace.open(files["straggler"][0], streaming=True)
    st = _open(files["straggler"], streaming=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        st.flat_profile(device="cuda")
