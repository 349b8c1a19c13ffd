"""The chrome reader's pid repair: a document whose pids mix integers and
strings, as a ``torch.profiler`` export writes them.

The reference sorts the raw pids with a plain ``sorted`` (eager reader,
chunked reader and unit planner alike), which raises a bare ``TypeError``
on such a document under every error policy.  The port orders numbers
first, by value, then every other pid by its string: an all-integer
document keeps the reference's dense ids, and a mixed one reads.  An
event whose ``tid`` is not an integer is handled as the reference handles
it: ``TraceReadError`` with the event's locus under ``strict``, skipped
and counted under ``skip``.
"""

import json

import numpy as np
import pytest

from repro.readers import chrome as ref_chrome
from repro_torch import Trace
from repro_torch.core import executor, registry
from repro_torch.core.constants import MPI_RECV, MPI_SEND, NAME, PROC
from repro_torch.core.errors import TraceReadError
from repro_torch.core.frame import concat
from repro_torch.readers import chrome

from test_conformance import assert_canonical_equal, canonical


def _events(pids, tids):
    """Two calls and a flow pair on each (pid, tid)."""
    out = []
    t = 10.0
    for pid, tid in zip(pids, tids):
        out.append({"ph": "X", "name": f"work{pid}", "pid": pid, "tid": tid,
                    "ts": t, "dur": 5.0})
        out.append({"ph": "B", "name": "outer", "pid": pid, "tid": tid,
                    "ts": t + 6.0})
        out.append({"ph": "E", "name": "outer", "pid": pid, "tid": tid,
                    "ts": t + 9.5})
        out.append({"ph": "s", "name": "ac2g", "id": 7, "pid": pid,
                    "tid": tid, "ts": t + 1.0})
        out.append({"ph": "f", "name": "ac2g", "id": 7, "pid": pid,
                    "tid": tid, "ts": t + 2.0, "bp": "e"})
        t += 20.0
    return out


#: a torch.profiler-like document: integer pids (host process, device 0),
#: string pids ("Spans", "Traces", ""), and two events with string tids
MIXED = {"traceEvents": (
    _events([4242, 0, 4242], [4242, 7, 4243])
    + [{"ph": "M", "name": "process_name", "pid": 4242, "tid": 0,
        "args": {"name": "python"}},
       {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)",
        "pid": "Spans", "tid": "PyTorch Profiler", "ts": 5.0,
        "dur": 100.0},
       {"ph": "M", "name": "process_sort_index", "pid": "Spans", "tid": 0,
        "args": {"sort_index": 5}},
       {"ph": "i", "s": "g", "name": "Iteration Start: PyTorch Profiler",
        "pid": "Traces", "tid": "Trace PyTorch Profiler", "ts": 5.0},
       {"ph": "i", "s": "g", "name": "Record Window End", "pid": "",
        "tid": "", "ts": 120.0}])}
#: the events above whose tid is a string
STRING_TIDS = 2


@pytest.fixture()
def mixed(tmp_path):
    p = str(tmp_path / "mixed.json")
    with open(p, "w") as f:
        json.dump(MIXED, f)
    return p


@pytest.mark.parametrize("on_error", ["strict", "skip"])
def test_reference_raises_typeerror_on_mixed_pids(mixed, on_error):
    with pytest.raises(TypeError, match="not supported"):
        ref_chrome.read_chrome(mixed, on_error=on_error)
    with pytest.raises(TypeError, match="not supported"):
        list(ref_chrome.iter_chunks_chrome(mixed, 64, on_error=on_error))
    with pytest.raises(TypeError, match="not supported"):
        ref_chrome.plan_units_chrome(mixed, 2)


def test_port_reads_mixed_pids_under_skip(mixed):
    t = Trace.open(mixed, on_error="skip", device="cpu")
    assert t.definitions["pids"] == [0, 4242, "", "Spans", "Traces"]
    rpt = t.ingest_report()
    assert rpt.total_skipped() == STRING_TIDS
    assert all("event" in e for e in rpt.errors())
    procs = np.asarray(t.events[PROC])
    names = np.asarray(t.events[NAME]).astype(str)
    # device pid 0 -> process 0, the host pid -> 1, "" -> 2
    assert set(procs[names == "work0"]) == {0}
    assert set(procs[names == "work4242"]) == {1}
    assert set(procs[names == "Record Window End"]) == {2}
    # every ac2g flow is a message instant: s a send, f a receive
    assert (names == MPI_SEND).sum() == (names == MPI_RECV).sum() == 3
    prof = t.flat_profile(device="cpu")
    assert set(np.asarray(prof[NAME]).astype(str)) >= {"work0", "work4242",
                                                      "outer"}


def test_port_strict_names_the_string_tid_event(mixed):
    with pytest.raises(TraceReadError, match=r"event \d+"):
        Trace.open(mixed, on_error="strict", device="cpu")


def test_chunked_and_unit_routes_read_mixed_pids(mixed):
    """The chunked reader and the planner's process units give the eager
    table of the same document."""
    eager = Trace.open(mixed, on_error="skip", device="cpu")
    want = canonical(eager)
    chunks = list(chrome.iter_chunks_chrome(mixed, 4, on_error="skip"))
    assert_canonical_equal(want, canonical(concat(chunks)), "chunked")
    units = chrome.plan_units_chrome(mixed, 3)
    assert [u.procs for u in units] == [(0,), (1, 2), (3, 4)]
    assert dict(units[0].extra)["known_pids"] == (0, 4242, "", "Spans",
                                                  "Traces")
    frames = [f for u in units for f in executor._unit_frames(
        u, "chrome", 5, None, {"on_error": "skip"})]
    assert_canonical_equal(want, canonical(concat(frames)), "units")
    st = Trace.open(mixed, streaming=True, chunk_rows=6, on_error="skip",
                    device="cpu")
    assert_canonical_equal(want, canonical(st.materialize()), "streamed")
    assert st.ingest_report().total_skipped() == STRING_TIDS


def test_all_integer_pids_keep_the_reference_dense_ids(tmp_path):
    doc = {"traceEvents": _events([300, 7, 12, 7], [1, 2, 3, 4])}
    p = str(tmp_path / "ints.json")
    with open(p, "w") as f:
        json.dump(doc, f)
    got = Trace.open(p, device="cpu")
    ref = ref_chrome.read_chrome(p)
    assert got.definitions["pids"] == ref.definitions["pids"] == [7, 12, 300]
    np.testing.assert_array_equal(np.asarray(got.events[PROC]),
                                  np.asarray(ref.events[PROC]))
    assert_canonical_equal(canonical(ref), canonical(got), "all-int")
    assert chrome._dense_pids({300, 7, 12}) == (7, 12, 300)
    assert [u.procs for u in chrome.plan_units_chrome(p, 2)] == \
        [u.procs for u in ref_chrome.plan_units_chrome(p, 2)]


def test_pid_key_orders_numbers_then_strings():
    assert chrome._dense_pids({"b", 3, "a", 1, 2.5}) == (1, 2.5, 3, "a", "b")


def _int_tid(e) -> bool:
    try:
        int(e.get("tid", 0) or 0)
    except ValueError:
        return False
    return True


def test_cpu_profiler_export_opens_under_skip(tmp_path):
    """A ``torch.profiler`` export of a few CPU ops opens with
    ``on_error="skip"``: the ops are named by ``flat_profile``, and the
    events with string tids are skipped and counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(32, 32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            (x @ x).relu().sum()
    p = str(tmp_path / "profile.json")
    prof.export_chrome_trace(p)
    with open(p) as f:
        raw = json.load(f)["traceEvents"]
    string_tids = sum(1 for e in raw if not _int_tid(e))
    assert registry.sniff_format(p) == "chrome"
    t = Trace.open(p, on_error="skip", device="cpu")
    assert t.ingest_report().total_skipped() == string_tids
    names = set(np.asarray(t.flat_profile(device="cpu")[NAME]).astype(str))
    assert {"aten::mm", "aten::relu"} <= names
