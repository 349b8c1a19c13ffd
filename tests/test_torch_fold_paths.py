"""``fold="chunks"`` beyond one op on one handle: ``diagnose`` in a pool
worker, negative message partners, set ops over folded members, a live
fleet and the trace-query service.

``diagnose``'s fold in a pool worker must hold ``stragglers``' chunk
records (no kernel call in the worker) for the parent to fold.
``comm_by_process``'s fold must wrap partners -1 and -2 as the eager op
does, though the process count is known only at the end.  Every set op
over ``fold="chunks"`` members must be within ``cardcheck.set_gate`` of
the same op over ``fold="once"`` members.
``LiveTraceSet(fold=)`` must hand the mode to every live handle it
builds.  The service must key its handles by ``fold`` and serve a folded
handle's results as the library computes them.  On the pathology traces
``diagnose``'s fold must name what the eager route names, within
``findings_gate``, and match the reference's streaming route.
"""

import asyncio
import json

import numpy as np
import pytest

from repro import tracegen as rtg
from repro.core.trace import Trace as RefTrace
from repro_torch import Trace, TraceSet
from repro_torch.core import executor, registry
from repro_torch.core import streaming as port_streaming
from repro_torch.core.constants import MPI_SEND
from repro_torch.core.detectors import _DiagnoseFold, _StragglerFold
from repro_torch.core.liveset import LiveTraceSet
from repro_torch.launch.cardcheck import (digest, findings_gate, op_gate,
                                          set_gate)
from repro_torch.readers import write_jsonl
from repro_torch.serving import protocol
from repro_torch.serving.protocol import ProtocolError, canonical_json
from repro_torch.serving.tracequery import TraceService, _normalize_open
from repro_torch.tracegen import big_trace

from test_torch_live import _fleet
from test_torch_ops import fresh_plan_cache  # noqa: F401
from test_torch_ops import to_port


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """A small ``big_trace`` at 4 and at 2 ranks, as per-rank pack
    shards."""
    d = tmp_path_factory.mktemp("foldpaths")
    return [big_trace(str(d / f"n{n}"), nprocs=n, events_per_proc=900,
                      calls_per_iter=30, seed=n, format="pack")
            for n in (4, 2)]


# ---------------------------------------------------------------------------
# diagnose over work units
# ---------------------------------------------------------------------------

def test_diagnose_in_a_pool_worker_holds_the_stragglers_parts(shards,
                                                               monkeypatch):
    """A unit folded as a pool worker folds it: ``deferred`` reaches
    ``stragglers``' fold, which holds one part a chunk and calls no
    kernel; the parent folds those parts, one launch each, and the
    pooled result is within the gate of the serial fold."""
    from repro_torch.core import accel
    paths = shards[0]
    h = port_streaming.StreamingTrace(paths, chunk_rows=211, device="cpu",
                                      processes=2, fold="chunks")
    spec = registry.get_op("diagnose")
    kw = {"device": "cpu"}
    unit = paths[0]
    stats = h.stats()

    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was called in the worker")

    with monkeypatch.context() as m:
        m.setattr(accel, "seg_sum", refuse)
        before = port_streaming.FOLDED_CHUNKS
        out = executor._run_unit((
            "fold", unit, h.format, h.chunk_rows, h.reader_kwargs, (),
            "diagnose", spec.streaming, (), kw, "chunks", stats))
        assert port_streaming.FOLDED_CHUNKS == before
    assert isinstance(out.agg, _DiagnoseFold) and out.agg.deferred
    (strag,) = [c for c in out.agg._children
                if isinstance(c, _StragglerFold)]
    chunks = -(-len(Trace.open(unit, device="cpu").events) // 211)
    assert strag.folds == 0 and len(strag._held) == chunks

    parent = port_streaming.make_agg("diagnose", spec.streaming, (), kw,
                                     "chunks")
    assert not parent.deferred
    before = port_streaming.FOLDED_CHUNKS
    got = executor.execute_parallel(h, (), spec, (), kw, parent,
                                    n_units=4, use_pool=False)
    assert port_streaming.FOLDED_CHUNKS - before == sum(
        -(-len(Trace.open(p, device="cpu").events) // 211) for p in paths)
    findings_gate(got, Trace.open(paths, streaming=True, chunk_rows=211,
                                  device="cpu", fold="chunks",
                                  cache=False).diagnose())


# ---------------------------------------------------------------------------
# negative message partners
# ---------------------------------------------------------------------------

def _sends_file(tmp_path, partners):
    """200 sends of four ranks to partners drawn from ``partners``, as a
    jsonl file written line by line (the port's writer leaves out a
    negative partner)."""
    rng = np.random.default_rng(1)
    path = tmp_path / "sends.jsonl"
    with open(path, "w") as f:
        for i, (dst, size) in enumerate(zip(rng.choice(partners, 200),
                                            rng.integers(1, 100, 200))):
            f.write(json.dumps({"ts": i, "et": "Instant", "name": MPI_SEND,
                                "proc": i // 50, "partner": int(dst),
                                "size": float(size)}) + "\n")
    return str(path)


@pytest.mark.parametrize("output", ["size", "count"])
def test_comm_by_process_fold_wraps_partners_minus_one_and_two(tmp_path,
                                                               output):
    """Partners -1 and -2 count as received by ranks n - 1 and n - 2, as
    the eager op's ``np.add.at`` wraps them (integer sizes: exact), at
    every chunk size and over work units; a partner outside a restricted
    selection raises the eager op's IndexError."""
    path = _sends_file(tmp_path, [-2, -1, 0, 1, 2, 3])
    eager = Trace.open(path, device="cpu").comm_by_process(output=output)
    assert set(np.asarray(Trace.open(path, device="cpu").events[
        "_partner"]).tolist()) == {-2, -1, 0, 1, 2, 3}
    for rows in (7, 31, 200):
        got = Trace.open(path, streaming=True, chunk_rows=rows,
                         device="cpu", fold="chunks",
                         cache=False).comm_by_process(output=output)
        assert digest(got) == digest(eager), rows
    h = port_streaming.StreamingTrace(path, chunk_rows=7, device="cpu",
                                      processes=2, fold="chunks")
    spec = registry.get_op("comm_by_process")
    kw = {"output": output, "device": "cpu"}
    got = executor.execute_parallel(
        h, (), spec, (), kw,
        port_streaming.make_agg("comm_by_process", spec.streaming, (), kw,
                                "chunks"), n_units=3, use_pool=False)
    assert digest(got) == digest(eager)
    with pytest.raises(IndexError):
        Trace.open(path, device="cpu").query().restrict_processes(
            [0, 1]).collect().comm_by_process()
    with pytest.raises(IndexError, match="partner"):
        Trace.open(path, streaming=True, chunk_rows=7, device="cpu",
                   fold="chunks").query().restrict_processes(
            [0, 1]).comm_by_process()


def test_comm_by_process_fold_refuses_a_partner_below_minus_n(tmp_path):
    path = _sends_file(tmp_path, [-5, 0, 1])
    with pytest.raises(IndexError):
        Trace.open(path, device="cpu").comm_by_process()
    with pytest.raises(IndexError, match="process range"):
        Trace.open(path, streaming=True, chunk_rows=13, device="cpu",
                   fold="chunks").comm_by_process()


# ---------------------------------------------------------------------------
# set ops over folded members
# ---------------------------------------------------------------------------

SET_CALLS = [("scaling_analysis", {}), ("regression_report", {}),
             ("diff_flat_profile", {"mode": "relative"}),
             ("diff_time_profile", {"num_bins": 12}),
             ("diff_load_imbalance", {})]


@pytest.mark.parametrize("op,kw", SET_CALLS, ids=[c[0] for c in SET_CALLS])
def test_set_ops_run_on_folded_members(shards, op, kw):
    """Each set op over ``fold="chunks"`` members is within the set gate
    of the same op over ``fold="once"`` members (which give the eager
    bits): process counts, durations, totals and statuses exact, the
    members' sums within the gate."""
    labels = ["n4", "n2"]
    once = TraceSet.open(shards, streaming=True, chunk_rows=97,
                         labels=labels, device="cpu")
    folded = TraceSet.open(shards, streaming=True, chunk_rows=97,
                           labels=labels, device="cpu", fold="chunks")
    assert [m.fold for m in folded] == ["chunks", "chunks"]
    set_gate(op, folded.run(op, **kw), once.run(op, **kw))


def test_an_in_memory_set_refuses_fold(shards):
    with pytest.raises(ValueError, match="fold only applies"):
        TraceSet.open(shards, device="cpu", fold="chunks")


# ---------------------------------------------------------------------------
# a live fleet
# ---------------------------------------------------------------------------

def test_liveset_hands_fold_to_its_live_handles(tmp_path):
    """``LiveTraceSet(fold="chunks")``: the survivors' handle and the
    per-rank members of ``to_traceset`` fold; each op's result is within
    the gate of the ``fold="once"`` fleet's."""
    fake = [1000.0]
    clock = lambda: fake[0]                                     # noqa: E731
    _fleet(tmp_path, 3, clock)
    folded = LiveTraceSet(str(tmp_path), clock=clock, device="cpu",
                          fold="chunks")
    once = LiveTraceSet(str(tmp_path), clock=clock, device="cpu")
    assert folded.trace().fold == "chunks" and once.trace().fold == "once"
    assert [m.fold for m in folded.to_traceset()] == ["chunks"] * 3
    for op, kw in (("flat_profile", {}), ("idle_time", {}),
                   ("comm_by_process", {}), ("diagnose", {})):
        got, cov, _wm = folded.run(op, **kw)
        want, _cov, _wm = once.run(op, **kw)
        assert cov.included == [0, 1, 2]
        op_gate(op, got, want)
    with pytest.raises(ValueError, match="fold must be"):
        LiveTraceSet(str(tmp_path), clock=clock, device="cpu", fold="all")


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------

def test_open_spec_carries_fold():
    """``fold`` is written into the normalized spec (``"once"`` when
    absent), so it keys the handle pool and the request keys; an absent
    key and ``"once"`` are one handle; ``"chunks"`` on an in-memory spec
    and an unknown mode are protocol errors."""
    paths = ["a.pack", "b.pack"]

    def key(spec):
        return canonical_json(_normalize_open(spec))

    for extra in ({"streaming": True}, {"mode": "live"},
                  {"mode": "set", "streaming": True}):
        base = dict({"paths": paths}, **extra)
        absent = _normalize_open(base)
        assert absent["fold"] == "once"
        assert key(base) == key(dict(base, fold="once"))
        folded = _normalize_open(dict(base, fold="chunks"))
        assert folded["fold"] == "chunks"
        assert key(dict(base, fold="chunks")) != key(base)
    assert _normalize_open({"paths": ["d"], "mode": "liveset",
                            "fold": "chunks"})["fold"] == "chunks"
    # /live reads a bare spec as live, where "chunks" applies
    assert _normalize_open({"paths": paths, "fold": "chunks"},
                           live=True)["mode"] == "live"
    for spec in ({"paths": paths, "fold": "chunks"},
                 {"paths": paths, "mode": "set", "fold": "chunks"},
                 {"paths": paths, "streaming": True, "fold": "all"}):
        with pytest.raises(ProtocolError, match="fold"):
            _normalize_open(spec)
    assert _normalize_open({"paths": paths})["fold"] == "once"


def _request(paths, op, fold, streaming=True, mode="trace", kwargs=None):
    return {"open": {"paths": paths, "streaming": streaming, "mode": mode,
                     "fold": fold},
            "op": op, "steps": [], "tenant": "t", "args": [],
            "kwargs": {k: protocol.encode_value(v)
                       for k, v in (kwargs or {}).items()}}


def test_served_folds_equal_the_library(shards):
    """``/query`` of ``idle_time`` and ``/diagnose`` on a ``"fold":
    "chunks"`` spec, and ``/setquery`` of ``scaling_analysis`` on folded
    members, give the library fold's digest; the folded and the
    buffering handle are two handles of the pool."""
    paths = shards[0]

    async def main():
        svc = TraceService(device="cpu", max_handles=4)
        idle = await svc.query(_request(paths, "idle_time", "chunks"))
        diag = await svc.query(_request(paths, "diagnose", "chunks"))
        once = await svc.query(_request(paths, "diagnose", "once"))
        scal = await svc.query(_request([shards[0], shards[1]],
                                        "scaling_analysis", "chunks",
                                        mode="set"), set_scope=True)
        return idle, diag, once, scal, svc.handles.opens

    idle, diag, once, scal, opens = asyncio.run(main())
    lib = Trace.open(paths, streaming=True, device="cpu", fold="chunks",
                     cache=False)
    assert idle["digest"] == protocol.result_digest(lib.idle_time())
    got = protocol.decode_value(json.loads(json.dumps(diag["result"])))
    assert digest(got) == digest(lib.diagnose())
    assert once["digest"] == protocol.result_digest(
        Trace.open(paths, streaming=True, device="cpu",
                   cache=False).diagnose())
    lib_set = TraceSet.open(shards, streaming=True, device="cpu",
                            fold="chunks")
    assert scal["digest"] == protocol.result_digest(
        lib_set.scaling_analysis())
    assert opens == 3  # folded trace, buffering trace, folded set


def test_served_live_poll_folds(tmp_path):
    """``/live`` on a ``"fold": "chunks"`` spec: the watermarked result is
    the library's live fold over the same committed prefix."""
    fake = [1000.0]
    _fleet(tmp_path, 2, lambda: fake[0])
    paths = [str(tmp_path / f"rank_{r}.pack") for r in range(2)]

    async def main():
        svc = TraceService(device="cpu")
        return await svc.live({"open": {"paths": paths, "fold": "chunks"},
                               "op": "comm_by_process", "tenant": "t"})

    out = asyncio.run(main())
    lib = port_streaming.LiveTrace(paths, device="cpu", fold="chunks",
                                   cache=False).comm_by_process()
    assert out["digest"] == protocol.result_digest(lib)


# ---------------------------------------------------------------------------
# the pathologies: diagnose's fold names what eager names
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pathology", ["late_sender", "serialization",
                                       "imbalance", "efficiency_drop"])
def test_diagnose_fold_on_each_pathology(tmp_path, pathology):
    """On each pathology trace (one jsonl file) ``diagnose``'s fold at 97
    rows a chunk is within ``findings_gate`` of the eager route and of the
    reference's streaming route, and its top finding is the eager one's."""
    ref, _gt = rtg.pathology_trace(pathology, nprocs=4, iters=16,
                                   magnitude=4.0, seed=2)
    path = str(tmp_path / f"{pathology}.jsonl")
    write_jsonl(to_port(ref), path)
    got = Trace.open(path, streaming=True, chunk_rows=97, device="cpu",
                     fold="chunks", cache=False).diagnose()
    eager = Trace.open(path, device="cpu").diagnose()
    assert len(eager) > 0
    findings_gate(got, eager)
    assert str(got["location"][0]) == str(eager["location"][0])
    findings_gate(got, RefTrace.open(path, streaming=True,
                                     chunk_rows=97).query().run(
        "diagnose", cache=False))
