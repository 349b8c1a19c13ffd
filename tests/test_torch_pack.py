"""The port's pipitpack store (``repro_torch.readers.pack``) and the pack
route of the main path.

The port's writer and the reference's write the same bytes for the same
events (footer, sidecar and content id included: the footer holds no
clock, pid or uuid), and each package reads the other's files.  For each of
the six ops the pack routes — eager, streamed, row-span work units,
``scan`` over pack shards — give the eager jsonl route's bits.  Index
pushdown skips the chunks the reference skips, and the integrity modes
(``strict``, ``skip_chunk``, ``salvage``) treat a damaged file as the
reference does.
"""

import warnings

import numpy as np
import pytest

from repro import tracegen as tg
from repro.core.trace import Trace as RefTrace
from repro.readers import pack as ref_pack
from repro.tracegen import big as ref_big
from repro_torch import Trace
from repro_torch.core import Filter, accel, executor, registry, structure
from repro_torch.core.constants import (DEPTH, ET, EXC, INC, MATCH, NAME,
                                        PARENT, PROC, TS)
from repro_torch.core.errors import TraceReadError
from repro_torch.core.query import scan
from repro_torch.core.streaming import StreamingTrace
from repro_torch.launch.cardcheck import digest
from repro_torch.readers import pack, write_jsonl
from repro_torch.tracegen import big_trace

from test_torch_ops import fresh_plan_cache  # noqa: F401
from test_torch_ops import OPS, to_port

TERMINALS = OPS + [("stragglers", {"threshold": -1.0})]
IDS = [f"{op}-{i}" for i, (op, _) in enumerate(TERMINALS)]
BASE = (TS, ET, NAME, PROC)
SIDECAR = (MATCH, DEPTH, PARENT, INC, EXC)


def _bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    """A jsonl trace both packages open (the straggler pathology trace) and
    its pack in chunk groups of 97 rows, plus 4-rank ``big_trace`` shards
    as jsonl and as pack."""
    d = tmp_path_factory.mktemp("pack")
    tr, _gt = tg.pathology_trace("straggler", nprocs=4, iters=24,
                                 magnitude=2.0, seed=11)
    j = str(d / "straggler.jsonl")
    write_jsonl(to_port(tr), j)
    one = str(d / "one.pack")
    Trace.open(j, device="cpu").save_pack(one, chunk_rows=97)
    kw = dict(nprocs=4, events_per_proc=1500, calls_per_iter=40, seed=3)
    return {"dir": d, "jsonl": j, "one": one,
            "shards": big_trace(str(d / "j"), **kw),
            "packs": big_trace(str(d / "p"), format="pack", **kw),
            "big_kw": kw}


def _same_columns(a, b, cols, context=""):
    for c in cols:
        va, vb = a.events[c], b.events[c]
        if np.asarray(va).dtype.kind in "UO":
            assert list(map(str, va)) == list(map(str, vb)), context
        else:
            np.testing.assert_array_equal(np.asarray(va), np.asarray(vb),
                                          err_msg=f"{context}: {c}")


# ---------------------------------------------------------------------------
# the same bytes, read both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["structured", "derived", "no-sidecar",
                                  "groups-of-37"])
def test_port_and_reference_write_the_same_bytes(src, tmp_path, case):
    port = Trace.open(src["jsonl"], device="cpu")
    ref = RefTrace.open(src["jsonl"])
    kw = {"chunk_rows": 37} if case == "groups-of-37" else {}
    if case == "structured":
        port._ensure_structure()
        ref._ensure_structure()
    sidecar = case != "no-sidecar"
    a, b = str(tmp_path / "port.pack"), str(tmp_path / "ref.pack")
    pack.write_pack(port, a, sidecar=sidecar, **kw)
    ref_pack.write_pack(ref, b, sidecar=sidecar, **kw)
    assert _bytes(a) == _bytes(b)
    assert pack.content_id(a) == ref_pack.content_id(b) is not None


def test_big_trace_and_streamed_conversion_write_the_same_bytes(src,
                                                                tmp_path):
    refs = ref_big.big_trace(str(tmp_path / "r"), format="pack",
                             **src["big_kw"])
    for a, b in zip(src["packs"], refs):
        assert _bytes(a) == _bytes(b)
    a, b = str(tmp_path / "s.pack"), str(tmp_path / "rs.pack")
    Trace.open(src["shards"], streaming=True, chunk_rows=500,
               device="cpu").save_pack(a, chunk_rows=700)
    RefTrace.open(src["shards"], streaming=True, chunk_rows=500,
                  cache=False).save_pack(b, chunk_rows=700)
    assert _bytes(a) == _bytes(b)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_package_reads_the_others_files(src, tmp_path, writer):
    p = str(tmp_path / "t.pack")
    if writer == "port":
        Trace.open(src["jsonl"], device="cpu").save_pack(p, chunk_rows=50)
    else:
        RefTrace.open(src["jsonl"]).save_pack(p, chunk_rows=50)
    port = Trace.open(p, device="cpu")
    ref = RefTrace.open(p)
    assert port._structured and ref._structured
    _same_columns(port, ref, BASE + SIDECAR, writer)
    frames = list(pack.iter_chunks_pack(p, 64))
    want = list(ref_pack.iter_chunks_pack(p, 64))
    assert [len(f) for f in frames] == [len(f) for f in want]
    for f, g in zip(frames, want):
        for c in (TS, PROC, MATCH, PARENT, INC):
            np.testing.assert_array_equal(np.asarray(f[c]), np.asarray(g[c]))


def test_v1_packs_stay_readable(src, tmp_path):
    """Version 1 (whole-file column-major, no groups): written here by
    hand in the reference's v1 layout."""
    import json
    import struct
    ev = Trace.open(src["jsonl"], device="cpu").events
    n = len(ev)
    cols = {"ts": np.asarray(ev[TS], "<i8"),
            "et": np.asarray(ev.codes(ET), "<i1"),
            "name": np.asarray(ev.codes(NAME), "<i4"),
            "proc": np.asarray(ev[PROC], "<i4")}
    p = str(tmp_path / "v1.pack")
    with open(p, "wb") as f:
        f.write(pack.MAGIC)
        meta = []
        for k, arr in cols.items():
            meta.append({"key": k, "dtype": arr.dtype.str,
                         "offset": f.tell()})
            f.write(arr.tobytes())
        footer = {"version": 1, "rows": n, "columns": meta,
                  "names": list(map(str, ev.cat(NAME).categories)),
                  "has_thread": False, "has_messages": False,
                  "chunks": [{"lo": 0, "hi": n, "ts_min": int(cols["ts"].min()),
                              "ts_max": int(cols["ts"].max()),
                              "procs": sorted(set(cols["proc"].tolist()))}],
                  "procs": sorted(set(cols["proc"].tolist()))}
        blob = json.dumps(footer).encode()
        f.write(blob)
        f.write(struct.pack("<Q", len(blob)))
        f.write(pack.TAIL_MAGIC)
    got = Trace.open(p, device="cpu")
    _same_columns(got, RefTrace.open(p), BASE, "v1")
    assert pack.verify_pack(p) == ref_pack.verify_pack(p)


# ---------------------------------------------------------------------------
# the pack routes give the eager bits
# ---------------------------------------------------------------------------

def _pack_routes(src):
    one = src["one"]
    packs = src["packs"]

    def units(paths, k):
        def run(op, kw):
            h = StreamingTrace(paths, chunk_rows=61, device="cpu",
                               processes=2)
            spec = registry.get_op(op)
            kw = dict(kw, device="cpu")
            return executor.execute_parallel(h, (), spec, (), kw,
                                             spec.streaming(**kw),
                                             n_units=k, use_pool=False)
        return run

    return {
        "eager-file": (src["jsonl"], lambda op, kw: Trace.open(
            one, device="cpu").run(op, **kw)),
        "streamed-file": (src["jsonl"], lambda op, kw: Trace.open(
            one, streaming=True, chunk_rows=61, device="cpu").run(op, **kw)),
        "rowspans-2": (src["jsonl"], units([one], 2)),
        "rowspans-7": (src["jsonl"], units([one], 7)),
        "eager-shards": (src["shards"], lambda op, kw: Trace.open(
            packs, device="cpu").run(op, **kw)),
        "streamed-shards": (src["shards"], lambda op, kw: Trace.open(
            packs, streaming=True, chunk_rows=256, device="cpu").run(
                op, **kw)),
        "shard-units": (src["shards"], units(packs, 4)),
        "scan-shards": (src["shards"], lambda op, kw: scan(
            packs, device="cpu").run(op, **kw)),
    }


ROUTES = ["eager-file", "streamed-file", "rowspans-2", "rowspans-7",
          "eager-shards", "streamed-shards", "shard-units", "scan-shards"]


@pytest.mark.parametrize("op,kw", TERMINALS, ids=IDS)
@pytest.mark.parametrize("route", ROUTES)
def test_pack_routes_give_the_eager_jsonl_bits(src, route, op, kw):
    jsonl_paths, run = _pack_routes(src)[route]
    want = Trace.open(jsonl_paths, device="cpu").run(op, **kw)
    assert digest(run(op, kw)) == digest(want)


def test_sidecar_reopen_derives_nothing(src):
    p = src["one"]
    before = structure.DERIVE_CALLS
    t = Trace.open(p, device="cpu")
    t.flat_profile()
    t.load_imbalance()
    Trace.open(p, streaming=True, chunk_rows=500,
               device="cpu").flat_profile()
    assert structure.DERIVE_CALLS == before
    bare = Trace.open(p, device="cpu", sidecar=False)
    bare.flat_profile()
    assert structure.DERIVE_CALLS == before + 1


def test_masked_pack_chunks_strip_the_sidecar_slices(src):
    """A plan that drops rows invalidates the chunk's row-localized
    structure: the stitcher derives again on the selected rows, and the
    result is the eager selection's."""
    p = src["one"]
    sel = Filter(NAME, "not-in", ["MPI_Send"])
    st = Trace.open(p, streaming=True, chunk_rows=61, device="cpu")
    want = Trace.open(src["jsonl"], device="cpu").query().filter(sel) \
        .collect().flat_profile()
    before = structure.DERIVE_CALLS
    got = st.query().filter(sel).flat_profile()
    assert digest(got) == digest(want)
    assert structure.DERIVE_CALLS > before


# ---------------------------------------------------------------------------
# index pushdown and units
# ---------------------------------------------------------------------------

def test_time_window_pushdown_skips_the_reference_chunks(src):
    p = src["one"]
    ts = np.asarray(Trace.open(p, device="cpu").events[TS], np.float64)
    t0, t1 = float(ts.min()), float(ts.min() + (ts.max() - ts.min()) * 0.1)
    hints = registry.PlanHints(time_window=(t0, t1))
    pack.reset_io_stats()
    got = list(pack.iter_chunks_pack(p, 64, hints))
    io = pack.io_stats()
    ref_pack.reset_io_stats()
    want = list(ref_pack.iter_chunks_pack(
        p, 64, ref_pack.PlanHints(time_window=(t0, t1))))
    assert io == ref_pack.io_stats()
    n_chunks = len(pack.read_footer(p)["chunks"])
    assert 0 < io["chunks_read"] < n_chunks
    assert io["chunks_read"] + io["chunks_skipped"] == n_chunks
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(f[TS]) for f in got]),
        np.concatenate([np.asarray(f[TS]) for f in want]))
    st = Trace.open(p, streaming=True, chunk_rows=64, device="cpu")
    plan = st.query().slice_time(t0, t1, trim="within")
    eager = Trace.open(p, device="cpu").query().slice_time(
        t0, t1, trim="within").collect()
    pack.reset_io_stats()
    assert digest(plan.flat_profile()) == digest(eager.flat_profile())
    assert pack.io_stats()["chunks_skipped"] == io["chunks_skipped"]


def test_process_restriction_skips_shards_and_chunks(src):
    packs = src["packs"]
    sel = Filter(PROC, "in", [1])
    want = digest(Trace.open(src["shards"][1], device="cpu").flat_profile())
    assert digest(scan(packs, device="cpu").filter(sel)
                  .flat_profile()) == want
    st = Trace.open(packs, streaming=True, chunk_rows=256, device="cpu")
    pack.reset_io_stats()
    assert digest(st.query().filter(sel).flat_profile()) == want
    io = pack.io_stats()
    # the other shards are skipped before their footers' chunks are read
    assert io["chunks_read"] == len(pack.read_footer(packs[1])["chunks"])
    assert io["chunks_skipped"] == 0
    assert pack._shard_procs_pack(packs[2]) == \
        ref_pack._shard_procs_pack(packs[2]) == {2}


@pytest.mark.parametrize("n", [1, 2, 3, 7, 100])
def test_plan_units_pack_is_the_reference_plan(src, n):
    p = src["one"]
    got = pack.plan_units_pack(p, n)
    want = ref_pack.plan_units_pack(p, n)
    if want is None:
        assert got is None
        return
    assert [(u.lo, u.hi) for u in got] == [(u.lo, u.hi) for u in want]
    rows = sum(len(f) for u in got
               for f in pack.iter_chunks_pack(p, 50, row_range=(u.lo, u.hi)))
    assert rows == pack.read_footer(p)["rows"]


# ---------------------------------------------------------------------------
# integrity: a damaged file, against the reference on the same file
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def damaged(src):
    """A pack of 6+ chunk groups with one byte flipped inside an interior
    group's column data, and the same file with its footer torn off."""
    d = src["dir"]
    good = str(d / "good.pack")
    Trace.open(src["jsonl"], device="cpu").save_pack(good, chunk_rows=80)
    chunks = pack.read_footer(good)["chunks"]
    victim = chunks[len(chunks) // 2]
    raw = bytearray(_bytes(good))
    raw[victim["offset"] + 5] ^= 0x40
    flip = str(d / "flip.pack")
    with open(flip, "wb") as f:
        f.write(raw)
    torn = str(d / "torn.pack")
    end = max(c["offset"] + c["nbytes"] + c["tlen"] + 16 for c in chunks)
    with open(torn, "wb") as f:
        f.write(raw[:end + 7])  # the groups, then a torn sidecar
    return {"good": good, "flip": flip, "torn": torn, "victim": victim,
            "chunks": chunks}


def test_verify_names_the_damaged_group(damaged):
    rep = pack.verify_pack(damaged["flip"])
    assert rep == ref_pack.verify_pack(damaged["flip"])
    assert not rep["ok"] and len(rep["chunks_bad"]) == 1
    assert rep["chunks_bad"][0]["offset"] == damaged["victim"]["offset"]
    assert pack.verify_pack(damaged["good"])["ok"]


def test_strict_refuses_a_torn_pack(damaged):
    with pytest.raises(TraceReadError, match="torn.pack"):
        pack.read_pack(damaged["torn"], device="cpu")
    with pytest.raises(ValueError, match="torn.pack"):
        ref_pack.read_pack(damaged["torn"])
    # strict is the zero-scan path on an intact footer, as in the
    # reference: it returns the stored bytes without a CRC pass
    assert len(pack.read_pack(damaged["flip"], device="cpu")) == \
        len(ref_pack.read_pack(damaged["flip"]))


def test_skip_chunk_drops_the_damaged_group(damaged):
    good = Trace.open(damaged["good"], device="cpu")
    v = damaged["victim"]
    before = pack.io_stats()["chunks_quarantined"]
    with pytest.warns(RuntimeWarning, match="quarantined 1"):
        t = pack.read_pack(damaged["flip"], on_error="skip_chunk",
                           device="cpu")
    assert pack.io_stats()["chunks_quarantined"] == before + 1
    with pytest.warns(RuntimeWarning):
        ref = ref_pack.read_pack(damaged["flip"], on_error="skip_chunk")
    _same_columns(t, ref, BASE, "skip_chunk")
    keep = np.ones(len(good), bool)
    keep[v["lo"]:v["hi"]] = False
    np.testing.assert_array_equal(np.asarray(t.events[TS]),
                                  np.asarray(good.events[TS])[keep])
    assert not t._structured  # the sidecar does not survive a quarantine


def test_salvage_recovers_every_clean_group(damaged, tmp_path):
    good = Trace.open(damaged["good"], device="cpu")
    with pytest.warns(RuntimeWarning):
        t = pack.read_pack(damaged["torn"], on_error="salvage",
                           device="cpu")
    with pytest.warns(RuntimeWarning):
        ref = ref_pack.read_pack(damaged["torn"], on_error="salvage")
    _same_columns(t, ref, BASE, "salvage")
    v = damaged["victim"]
    keep = np.ones(len(good), bool)
    keep[v["lo"]:v["hi"]] = False
    for c in BASE:
        np.testing.assert_array_equal(
            np.asarray(t.events[c]).astype(str) if c == NAME
            else np.asarray(t.events[c]),
            np.asarray(good.events[c])[keep].astype(str) if c == NAME
            else np.asarray(good.events[c])[keep])
    a, b = str(tmp_path / "a.pack"), str(tmp_path / "b.pack")
    with pytest.warns(RuntimeWarning):
        rep = pack.repair_pack(damaged["torn"], a)
    with pytest.warns(RuntimeWarning):
        ref_rep = ref_pack.repair_pack(damaged["torn"], b)
    assert _bytes(a) == _bytes(b)
    assert rep["rows_recovered"] == ref_rep["rows_recovered"] == keep.sum()
    assert rep["footer_rebuilt"]


def test_append_commit_and_committed_prefix_match_reference(src, tmp_path):
    ev = Trace.open(src["jsonl"], device="cpu").events
    p = str(tmp_path / "live.pack")
    w = pack.PackWriter.open_append(p, chunk_rows=1000, fsync=False)
    half = len(ev) // 2
    w.append(ev.take(np.arange(half)))
    w.commit()
    snap = pack.committed_prefix(p)
    assert snap == ref_pack.committed_prefix(p)
    assert snap["rows"] == half and not snap["finalized"]
    w.append(ev.take(np.arange(half, len(ev))))
    w.finalize()
    assert len(Trace.open(p, device="cpu")) == len(ev)
    assert pack.committed_prefix(p) == ref_pack.committed_prefix(p)


def test_read_only_columns_reach_the_kernels_without_a_warning(src):
    """Pack columns are mapped read-only; the host-to-tensor adapters copy
    such an array instead of handing it to ``torch.from_numpy``."""
    codes = np.arange(64, dtype=np.int32) % 5
    vals = np.linspace(0, 1, 64, dtype=np.float32)
    for a in (codes, vals):
        a.flags.writeable = False
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = accel.seg_sum(codes, vals, 5, device="cpu")
        pair = accel.pair_sum(codes, codes, vals, 5, 5, device="cpu")
    want = np.bincount(codes, vals.astype(np.float64), minlength=5)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(np.diag(pair), want, rtol=1e-6)
    assert not codes.flags.writeable  # the caller's array is untouched
