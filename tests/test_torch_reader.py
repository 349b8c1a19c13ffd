"""The port's jsonl reader and trace generator against the reference."""

import filecmp

import numpy as np
import pytest

from repro import tracegen as tg
from repro.core.trace import Trace as RefTrace
from repro.readers.jsonl import write_jsonl
from repro_torch import Trace
from repro_torch.core.constants import (DEPTH, EXC, INC, MATCH, MATCH_TS,
                                        PARENT)
from repro_torch.tracegen import big_events, big_trace

STRUCTURE = (MATCH, MATCH_TS, DEPTH, PARENT, INC, EXC)


def assert_same_events(port_ev, ref_ev, columns=None):
    """Same columns, dtypes, values and category tables."""
    columns = columns or ref_ev.columns
    assert port_ev.columns == ref_ev.columns
    for c in columns:
        a, b = port_ev.column(c), ref_ev.column(c)
        if hasattr(b, "codes"):
            np.testing.assert_array_equal(a.codes, b.codes, err_msg=c)
            assert list(a.categories) == list(b.categories), c
        else:
            assert a.dtype == b.dtype, c
            np.testing.assert_array_equal(a, b, err_msg=c)


@pytest.mark.parametrize("gen", ["gol", "tortuga"])
def test_reader_gives_reference_columns_and_structure(tmp_path, gen):
    ref_src = getattr(tg, gen)(nprocs=4, iters=2)
    path = str(tmp_path / f"{gen}.jsonl")
    write_jsonl(ref_src, path)
    ref = RefTrace.open(path)
    port = Trace.open(path, device="cpu")
    assert port.ingest_report().clean
    assert_same_events(port.events, ref.events)
    ref._ensure_structure()
    port._ensure_structure()
    assert_same_events(port.events, ref.events)
    for c in STRUCTURE:
        assert c in port.events.columns, c


def test_reader_skip_policy_counts_malformed_lines(tmp_path):
    path = tmp_path / "bad.jsonl"
    path.write_text('{"ts": 1, "et": "Enter", "name": "f", "proc": 0}\n'
                    'not json\n'
                    '{"ts": 2, "et": "Leave", "name": "f", "proc": 0}\n')
    port = Trace.open(str(path), device="cpu", on_error="skip")
    assert len(port) == 2
    assert port.ingest_report().total_skipped() == 1


def test_big_trace_files_identical_to_reference(tmp_path):
    kw = dict(nprocs=3, events_per_proc=1200, calls_per_iter=30, seed=5)
    ref_paths = tg.big_trace(str(tmp_path / "ref"), **kw)
    port_paths = big_trace(str(tmp_path / "port"), **kw)
    assert len(ref_paths) == len(port_paths) == 3
    for a, b in zip(ref_paths, port_paths):
        assert filecmp.cmp(a, b, shallow=False), (a, b)


def test_big_events_equal_reference_shard_read(tmp_path):
    kw = dict(nprocs=4, events_per_proc=900, calls_per_iter=20, seed=2)
    ref = RefTrace.open(tg.big_trace(str(tmp_path / "ref"), **kw))
    port_mem = big_events(**kw)
    assert_same_events(port_mem, ref.events)
    port_read = Trace.open(big_trace(str(tmp_path / "port"), **kw),
                           device="cpu")
    assert_same_events(port_read.events, ref.events)
