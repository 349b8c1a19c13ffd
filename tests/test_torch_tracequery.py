"""The port's trace-query service: wire protocol, per-op conformance with
the library, single-flight coalescing, admission control, deadlines,
graceful shutdown, the HTTP client, and the kernel layer under its lane
threads.

Mirrors ``tests/test_serving.py``, its set (``/setquery``) and diagnose
(``/diagnose``) cases included.  The same pack shards go to the
reference's service and the port's: the port's served result is its
library call's bits, and within the ``bench_backends.py`` gate of the
reference's served ``pallas`` result.
"""

import asyncio
import json
import threading
import time
import types

import numpy as np
import pytest
import torch

from repro.core import plancache as ref_plancache
from repro.core.filters import Filter as RefFilter
from repro.core.frame import EventFrame as RefEventFrame
from repro.serving import protocol as ref_protocol
from repro.serving.tracequery import TraceService as RefTraceService
from repro_torch import Trace, TraceSet
from repro_torch.core import plancache, registry
from repro_torch.core.cancellation import (CancelToken, ExecutionCancelled,
                                           cancel_scope, check_cancelled)
from repro_torch.core.filters import Filter
from repro_torch.core.frame import Categorical, EventFrame
from repro_torch.core.scheduler import Scheduler, get_scheduler, \
    set_scheduler
from repro_torch.kernels import build, hist_bin, seg_sum
from repro_torch.launch.cardcheck import digest
from repro_torch.readers.pack import repair_pack
from repro_torch.serving import protocol
from repro_torch.serving.client import RemoteError, ServiceClient
from repro_torch.serving.protocol import ProtocolError, result_digest
from repro_torch.serving.tracequery import (ServiceError, TraceServer,
                                            TraceService)
from repro_torch.tracegen import big_trace

from test_torch_ops import fresh_plan_cache  # noqa: F401
from test_torch_ops import OPS, assert_equivalent
from test_torch_stragglers import assert_findings

TERMINALS = OPS + [("stragglers", {"threshold": -1.0})]
IDS = [f"{op}-{i}" for i, (op, _) in enumerate(TERMINALS)]


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pack_paths(tmp_path_factory):
    out = tmp_path_factory.mktemp("serve_trc")
    return big_trace(str(out), nprocs=4, events_per_proc=600,
                     calls_per_iter=40, seed=11, format="pack")


@pytest.fixture()
def quota_reset():
    yield
    plancache.configure(enabled=True, tenant_quota=0)


@pytest.fixture()
def sleep_op():
    @registry.register_op("_serve_sleep")
    def _serve_sleep(trace, duration=0.2, tag=0, device=None):
        time.sleep(float(duration))
        return float(len(trace.events)) + float(tag)

    yield "_serve_sleep"
    registry._OP_REGISTRY.pop("_serve_sleep", None)


def run(coro):
    return asyncio.run(coro)


def payload(paths, op, steps=None, streaming=False, tenant="t", args=(),
            kwargs=None, **extra):
    body = {"open": {"paths": list(paths), "streaming": streaming},
            "op": op, "steps": steps or [], "tenant": tenant,
            "args": [protocol.encode_value(a) for a in args],
            "kwargs": {k: protocol.encode_value(v)
                       for k, v in (kwargs or {}).items()}}
    body.update(extra)
    return body


def service(**kw):
    return TraceService(device="cpu", **kw)


# ---------------------------------------------------------------------------
# protocol
# ---------------------------------------------------------------------------

def test_value_roundtrip_bit_exact():
    ev = EventFrame({"Name": ["a", "b", "a"],
                     "x": np.asarray([1.5, np.nan, 3.0]),
                     "n": np.asarray([1, 2, 3], np.int64)})
    values = [ev, np.arange(12, dtype=np.float32).reshape(3, 4),
              (np.arange(3), np.arange(4.0)), [ev, ev],
              {"k": 1, "v": np.arange(2)},
              np.asarray(["x", "y"], object), np.float64(3.25), None,
              True, "s", 7, 2.5]
    for val in values:
        wire = json.loads(json.dumps(protocol.encode_value(val)))
        assert result_digest(protocol.decode_value(wire)) == \
            result_digest(val)


def test_wire_and_digests_match_the_reference():
    """The same values give the reference's wire JSON and digests, so a
    client of either package reads the other's responses."""
    cols = {"Name": np.asarray(["a", "b", "a"], object),
            "x": np.asarray([1.5, np.nan, 3.0]),
            "n": np.asarray([1, 2, 3], np.int64)}
    pairs = [(EventFrame(dict(cols)), RefEventFrame(dict(cols))),
             ((np.arange(3), np.arange(4.0)),) * 2,
             ({"k": np.float32(2.5)},) * 2]
    for ours, theirs in pairs:
        assert json.dumps(protocol.encode_value(ours)) == \
            json.dumps(ref_protocol.encode_value(theirs))
        assert result_digest(ours) == ref_protocol.result_digest(theirs)
    f = (Filter("Name", "in", ["a", "b"]) & Filter("Process", "<", 4)) | \
        ~Filter("Event Type", "==", "Enter")
    g = (RefFilter("Name", "in", ["a", "b"]) & RefFilter("Process", "<", 4)
         ) | ~RefFilter("Event Type", "==", "Enter")
    assert protocol.encode_filter(f) == ref_protocol.encode_filter(g)


def test_digest_representation_independent():
    cat = Categorical.from_values(np.asarray(["a", "b", "a"], object))
    assert result_digest(cat) == result_digest(cat.to_strings())
    assert result_digest((1, 2)) == result_digest([1, 2])


def test_filter_roundtrip():
    f = (Filter("Name", "in", ["a", "b"]) & Filter("Process", "<", 4)) | \
        ~Filter("Event Type", "==", "Enter")
    wire = json.loads(json.dumps(protocol.encode_filter(f)))
    assert repr(protocol.decode_filter(wire)) == repr(f)


def test_custom_filter_subclass_and_callables_rejected():
    class Weird(Filter):
        pass

    with pytest.raises(ProtocolError):
        protocol.encode_filter(Weird("Name", "==", "a"))
    with pytest.raises(ProtocolError):
        protocol.encode_value(lambda x: x)


def test_apply_steps_equals_direct_chain(pack_paths):
    trace = Trace.open(pack_paths[0], device="cpu")
    direct = (trace.query().slice_time(0.0, 40.0, trim="within")
              .filter(Filter("Process", "==", 0)).flat_profile())
    wire = [{"k": "slice_time", "start": 0.0, "end": 40.0,
             "trim": "within"},
            {"k": "filter", "filter": protocol.encode_filter(
                Filter("Process", "==", 0))}]
    replayed = protocol.apply_steps(trace.query(), wire).flat_profile()
    assert result_digest(replayed) == result_digest(direct)


# ---------------------------------------------------------------------------
# per-op conformance: served result == library call, every op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("op,kw", TERMINALS, ids=IDS)
def test_every_op_served_equals_library_and_reference(pack_paths, op, kw,
                                                      streaming):
    """The served result (decoded from the wire) is the library call's
    bits on the same handle configuration, and within the gate of the
    reference service's ``pallas`` result on the same shards."""
    async def main():
        ours = await service(max_handles=4).query(
            payload(pack_paths, op, kwargs=kw, streaming=streaming))
        ref_plancache.clear()
        theirs = await RefTraceService(max_handles=4).query(
            payload(pack_paths, op, streaming=streaming, cache=False,
                    kwargs=dict(kw, backend="pallas")))
        return ours, theirs

    ours, theirs = run(main())
    got = protocol.decode_value(json.loads(json.dumps(ours["result"])))
    lib = Trace.open(pack_paths, streaming=streaming, device="cpu",
                     **({"cache": False} if streaming else {})).run(op, **kw)
    assert ours["digest"] == result_digest(lib) == result_digest(got)
    want = ref_protocol.decode_value(theirs["result"])
    if op == "stragglers":
        assert_findings(got, want, op)
    else:
        assert_equivalent(op, got, want, context=op)


# ---------------------------------------------------------------------------
# sets (/setquery) and the detector suite (/diagnose)
# ---------------------------------------------------------------------------

def set_payload(paths, op, **extra):
    body = payload(paths, op, **extra)
    body["open"]["mode"] = "set"
    return body


SET_OPS = ["diff_flat_profile", "diff_time_profile", "scaling_analysis",
           "diff_load_imbalance", "regression_report"]


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("op", SET_OPS)
def test_every_set_op_roundtrips(pack_paths, op, streaming):
    """Each set op served through ``/setquery`` is the library's bits, and
    within the gate of the reference service's result on the same
    shards (rows keyed by name, as in ``test_torch_diff.py``)."""
    from repro.core.trace import Trace as RefTrace
    from test_torch_diff import assert_set_result

    async def main():
        ours = await service(max_handles=4).query(
            set_payload(pack_paths[:2], op, streaming=streaming),
            set_scope=True)
        ref_plancache.clear()
        theirs = await RefTraceService(max_handles=4).query(
            set_payload(pack_paths[:2], op, streaming=streaming,
                        cache=False), set_scope=True)
        return ours, theirs

    ours, theirs = run(main())
    got = protocol.decode_value(json.loads(json.dumps(ours["result"])))
    lib = TraceSet.open(pack_paths[:2], streaming=streaming,
                        device="cpu").run(op)
    assert ours["digest"] == result_digest(lib) == result_digest(got)
    want = ref_protocol.decode_value(theirs["result"])
    refs = [RefTrace.open(p) for p in pack_paths[:2]]
    assert_set_result(op, got, want, refs, {}, op)


def test_trace_op_mapped_over_set(pack_paths):
    async def main():
        return await service().query(
            set_payload(pack_paths[:2], "flat_profile"), set_scope=True)

    got = protocol.decode_value(run(main())["result"])
    want = TraceSet.open(pack_paths[:2], device="cpu").query().run(
        "flat_profile")
    assert isinstance(got, list) and len(got) == 2
    assert result_digest(got) == result_digest(want)


def test_http_setquery_roundtrip(pack_paths):
    """``open_set`` with members that are lists of shards (all four ranks,
    then the first two), labelled and streamed: the library's digest, and
    a repeat answered from the cache."""
    members = [list(pack_paths), list(pack_paths[:2])]
    local = TraceSet.open(members, streaming=True, labels=["n4", "n2"],
                          device="cpu").query().run("regression_report")

    async def main():
        server = await TraceServer(service(), port=0).start()

        def client_work():
            with ServiceClient("127.0.0.1", server.port) as c:
                tset = c.open_set(members, streaming=True,
                                  labels=["n4", "n2"])
                got = tset.query().regression_report()
                again = tset.query().regression_report()
                return got, again, dict(c.last_meta)

        out = await asyncio.to_thread(client_work)
        await server.shutdown(grace=5)
        return out

    got, again, meta = run(main())
    assert result_digest(got) == result_digest(local) == \
        result_digest(again)
    assert meta["cached"]


@pytest.fixture(scope="module")
def pathology_pack(tmp_path_factory):
    from repro_torch.readers.pack import write_pack
    from repro_torch.tracegen import pathology_trace
    tr, gt = pathology_trace("straggler", nprocs=3, iters=12, magnitude=2.0,
                             seed=4, device="cpu")
    p = str(tmp_path_factory.mktemp("diag_serve") / "patho.pack")
    write_pack(tr, p)
    return p, gt


def test_diagnose_endpoint_digest_equals_library(pathology_pack):
    from test_torch_detectors import assert_findings_match
    path, gt = pathology_pack
    local = Trace.open(path, device="cpu").query().run("diagnose")

    async def main():
        server = await TraceServer(service(), port=0).start()

        def client_work():
            with ServiceClient("127.0.0.1", server.port, tenant="t") as c:
                trace = c.open(path)
                return (trace.diagnose(), trace.query().diagnose(),
                        trace.diagnose(detectors=["stragglers"]))

        result = await asyncio.to_thread(client_work)
        await server.shutdown(grace=5)
        ref_plancache.clear()
        theirs = await RefTraceService().query(
            payload([path], "diagnose", cache=False))
        return result, theirs

    (via_endpoint, via_query, subset), theirs = run(main())
    assert result_digest(via_endpoint) == result_digest(local)
    assert result_digest(via_query) == result_digest(local)
    assert result_digest(subset) == result_digest(
        Trace.open(path, device="cpu").query().run(
            "diagnose", detectors=["stragglers"]))
    assert int(subset["process"][0]) == gt.process
    assert_findings_match(via_endpoint,
                          ref_protocol.decode_value(theirs["result"]),
                          "diagnose")


def test_diagnose_requests_coalesce_and_cache(pathology_pack):
    path, _ = pathology_pack

    async def main():
        svc = service()
        body = payload([path], "diagnose")
        results = await asyncio.gather(
            *[svc.query(dict(body)) for _ in range(5)])
        again = await svc.query(dict(body))
        return svc, results, again

    svc, results, again = run(main())
    assert svc.counters["executed"] == 1
    assert svc.counters["coalesced"] == 4
    assert len({r["digest"] for r in results}) == 1
    assert again.get("cached") and again["digest"] == results[0]["digest"]


def test_streaming_digest_matches_eager(pack_paths):
    resp = run(service().query(payload(pack_paths, "flat_profile",
                                       streaming=True)))
    want = Trace.open(pack_paths, device="cpu").query().flat_profile()
    assert resp["digest"] == result_digest(want)


# ---------------------------------------------------------------------------
# single-flight coalescing and the cache
# ---------------------------------------------------------------------------

def test_identical_inflight_plans_coalesce(pack_paths, sleep_op):
    async def main():
        svc = service()
        body = payload(pack_paths[:1], sleep_op, cache=False,
                       kwargs={"duration": 0.05})
        results = await asyncio.gather(
            *[svc.query(dict(body)) for _ in range(6)])
        return svc, results

    svc, results = run(main())
    assert svc.counters["executed"] == 1
    assert svc.counters["coalesced"] == 5
    assert len({r["digest"] for r in results}) == 1
    assert sum(1 for r in results if r.get("coalesced")) == 5


def test_distinct_plans_do_not_coalesce(pack_paths, sleep_op):
    async def main():
        svc = service(per_tenant=8)
        bodies = [payload(pack_paths[:1], sleep_op, cache=False,
                          kwargs={"duration": 0.01, "tag": i})
                  for i in range(3)]
        results = await asyncio.gather(*[svc.query(b) for b in bodies])
        return svc, results

    svc, results = run(main())
    assert svc.counters["executed"] == 3
    assert svc.counters["coalesced"] == 0
    assert len({r["digest"] for r in results}) == 3


def test_repeat_request_hits_shared_cache(pack_paths, monkeypatch):
    """A repeat is answered from the cache: no op runs (no kernel call)."""
    async def main(svc, body):
        return await svc.query(dict(body))

    svc = service()
    body = payload(pack_paths, "flat_profile", streaming=True,
                   tenant="alice")
    first = run(main(svc, body))
    calls = []
    monkeypatch.setattr(seg_sum, "seg_sum",
                        lambda *a, **k: calls.append(a) or None)
    second = run(main(svc, body))
    assert not first.get("cached") and second.get("cached")
    assert first["digest"] == second["digest"] and calls == []
    assert svc.counters["cache_hits"] == 1
    assert plancache.stats()["tenants"]["alice"]["hits"] >= 1


def test_the_device_is_part_of_the_wire_key(pack_paths):
    """Two services on different devices never share an entry."""
    body = payload(pack_paths, "flat_profile", streaming=True)
    svc = service()
    spec = svc._decode(body)[0]
    other = service()
    other.device = torch.device("cuda")
    assert svc._wire_key(spec, [], "flat_profile", body, False) != \
        other._wire_key(spec, [], "flat_profile", body, False)


# ---------------------------------------------------------------------------
# admission control, deadlines, drain
# ---------------------------------------------------------------------------

def test_per_tenant_concurrency_rejects_floods(pack_paths, sleep_op):
    async def main():
        svc = service(per_tenant=1, max_active=64)
        bodies = [payload(pack_paths[:1], sleep_op, cache=False,
                          tenant="greedy",
                          kwargs={"duration": 0.05, "tag": i})
                  for i in range(10)]
        results = await asyncio.gather(*[svc.query(b) for b in bodies],
                                       return_exceptions=True)
        return svc, results

    svc, results = run(main())
    rejected = [r for r in results if isinstance(r, ServiceError)]
    assert rejected and all(r.code == "tenant_saturated" for r in rejected)
    assert [r for r in results if isinstance(r, dict)]
    assert svc.counters["rejected"] == len(rejected)
    assert svc.tenant_counters["greedy"]["rejected"] == len(rejected)


def test_other_tenant_unaffected_by_flood(pack_paths, sleep_op):
    async def main():
        svc = service(per_tenant=1, max_active=64)
        flood = [svc.query(payload(
            pack_paths[:1], sleep_op, cache=False, tenant="greedy",
            kwargs={"duration": 0.05, "tag": i})) for i in range(8)]
        polite = svc.query(payload(
            pack_paths[:1], sleep_op, cache=False, tenant="polite",
            kwargs={"duration": 0.01, "tag": 99}))
        return (await asyncio.gather(*flood, polite,
                                     return_exceptions=True))[-1]

    polite = run(main())
    assert isinstance(polite, dict) and polite["ok"]


def test_tenant_plan_cache_quota(pack_paths, quota_reset):
    async def main():
        svc = service(tenant_quota=2)
        for i in range(5):
            await svc.query(payload(
                pack_paths, "time_profile", streaming=True, tenant="alice",
                kwargs={"num_bins": 4 + i}))

    run(main())
    st = plancache.stats()
    assert st["tenant_quota"] == 2
    assert st["tenants"]["alice"]["entries"] <= 2
    assert st["tenants"]["alice"]["evictions"] >= 3


def test_interactive_lane_survives_bulk_saturation(pack_paths, sleep_op):
    prev = set_scheduler(Scheduler(workers=2, interactive_workers=1))
    try:
        async def main():
            svc = service(per_tenant=8)
            bulk = [asyncio.ensure_future(svc.query(payload(
                pack_paths[:1], sleep_op, cache=False, lane="bulk",
                kwargs={"duration": 0.4, "tag": i}))) for i in range(2)]
            await asyncio.sleep(0.05)
            t0 = time.perf_counter()
            inter = await svc.query(payload(
                pack_paths[1:2], sleep_op, cache=False, lane="interactive",
                kwargs={"duration": 0.01, "tag": 9}))
            latency = time.perf_counter() - t0
            await asyncio.gather(*bulk)
            return inter, latency

        inter, latency = run(main())
        assert inter["ok"] and latency < 0.35
    finally:
        sched = set_scheduler(prev)
        if sched is not None:
            sched.shutdown()


def test_deadline_cancels_the_plan_at_a_chunk(pack_paths):
    """Past its deadline a request is answered 504 at once, and the lane
    thread running it stops at the next chunk boundary with
    ``ExecutionCancelled``."""
    ended = []
    real = TraceService._execute

    def slow(self, *a, **k):
        try:
            time.sleep(0.2)      # the deadline passes while the plan waits
            return real(self, *a, **k)
        except ExecutionCancelled as e:
            ended.append(str(e))
            raise

    async def main():
        svc = service()
        svc._execute = types.MethodType(slow, svc)
        with pytest.raises(ServiceError) as exc:
            await svc.query(payload(pack_paths, "flat_profile",
                                    streaming=True, chunk_rows=64,
                                    cache=False, deadline_ms=50))
        return svc, exc.value

    svc, err = run(main())
    assert err.status == 504 and err.code == "deadline_exceeded"
    assert svc.counters["deadline_exceeded"] == 1
    for _ in range(100):
        if ended:
            break
        time.sleep(0.05)
    assert ended == ["request deadline exceeded"]


def test_cancel_scope_is_per_thread():
    tok = CancelToken("stop")
    tok.cancel()
    seen = []
    t = threading.Thread(target=lambda: seen.append(check_cancelled()))
    with cancel_scope(tok):
        t.start()
        t.join(timeout=10)
        with pytest.raises(ExecutionCancelled, match="stop"):
            check_cancelled()
    assert not t.is_alive() and seen == [None]
    check_cancelled()          # no scope bound: a no-op


def test_drain_finishes_inflight_and_refuses_new(pack_paths, sleep_op):
    async def main():
        svc = service()
        slow = asyncio.ensure_future(svc.query(payload(
            pack_paths[:1], sleep_op, cache=False,
            kwargs={"duration": 0.3})))
        await asyncio.sleep(0.05)
        drained = asyncio.ensure_future(svc.drain(timeout=5))
        await asyncio.sleep(0.01)
        with pytest.raises(ServiceError) as exc:
            await svc.query(payload(pack_paths[:1], "flat_profile"))
        slow_result = await slow
        return await drained, exc.value, slow_result

    drained, err, slow_result = run(main())
    assert drained is True
    assert err.status == 503 and err.code == "draining"
    assert slow_result["ok"]


# ---------------------------------------------------------------------------
# handle pool
# ---------------------------------------------------------------------------

def test_handle_reopened_when_pack_rewritten(tmp_path):
    out = tmp_path / "trc"
    path = big_trace(str(out), nprocs=1, events_per_proc=300,
                     calls_per_iter=20, seed=1, format="pack")[0]

    async def main():
        svc = service()
        first = await svc.query(payload([path], "flat_profile"))
        big_trace(str(out), nprocs=1, events_per_proc=300,
                  calls_per_iter=20, seed=2, format="pack")
        second = await svc.query(payload([path], "flat_profile"))
        return svc, first, second

    svc, first, second = run(main())
    assert first["digest"] != second["digest"]
    assert svc.handles.stats()["reopens"] == 1
    assert second["digest"] == result_digest(
        Trace.open(path, device="cpu").flat_profile())


def test_handle_pool_lru_bound(pack_paths):
    async def main():
        svc = service(max_handles=2)
        for p in pack_paths[:3]:
            await svc.query(payload([p], "flat_profile"))
        return svc.handles.stats()

    st = run(main())
    assert st["open"] == 2 and st["evictions"] == 1


def test_unknown_op_and_bad_requests(pack_paths):
    async def main():
        svc = service()
        with pytest.raises(ProtocolError):
            await svc.query(payload(pack_paths[:1], "no_such_op"))
        with pytest.raises(ProtocolError):
            await svc.query({"op": "flat_profile"})
        with pytest.raises(ServiceError) as exc:
            await svc.query(payload(["/no/such/file.pack"], "flat_profile"))
        assert exc.value.status == 404
        body = payload(pack_paths[:2], "flat_profile")
        body["open"]["mode"] = "set"
        with pytest.raises(ProtocolError, match="/setquery"):
            await svc.query(body)
        with pytest.raises(ProtocolError, match="comparison op"):
            await svc.query(payload(pack_paths[:2], "regression_report"))
        body["op"] = "regression_report"
        res = await svc.query(body, set_scope=True)
        assert res["ok"]
        with pytest.raises(ProtocolError, match="paths"):
            await svc.query({"open": {"paths": [["a"]]}, "op": "diagnose"})
        with pytest.raises(ProtocolError, match="labels"):
            await svc.query({"open": {"paths": pack_paths[:2],
                                      "labels": ["x"]},
                             "op": "regression_report"}, set_scope=True)
        return res

    res = run(main())
    want = TraceSet.open(pack_paths[:2], device="cpu").regression_report()
    assert res["digest"] == result_digest(want)


def test_breaker_recovers_after_repair(tmp_path):
    """Opens of a damaged pack trip the breaker (422 fast-fails) until the
    cooldown lapses after a repair; the probe then closes it."""
    out = tmp_path / "trc"
    path = big_trace(str(out), nprocs=1, events_per_proc=300,
                     calls_per_iter=20, seed=3, format="pack")[0]
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[: int(len(data) * 0.6)])

    async def main():
        svc = service(breaker_threshold=2, breaker_cooldown=30.0)
        codes = []
        for _ in range(4):
            try:
                await svc.query(payload([path], "flat_profile"))
                codes.append("ok")
            except ServiceError as e:
                codes.append((e.status, e.code))
        assert codes[1] == codes[3] == (422, "source_corrupt")
        st = svc.handles.stats()
        assert st["breaker_trips"] == 1 and st["breaker_open"] == 1
        fixed = path + ".fixed"
        repair_pack(path, fixed)
        import os
        os.replace(fixed, path)
        with pytest.raises(ServiceError, match="source_corrupt|open fail"):
            await svc.query(payload([path], "flat_profile"))
        for b in svc.handles._fails.values():
            b["until"] = 0.0
        res = await svc.query(payload([path], "flat_profile"))
        assert res["ok"] and svc.handles.stats()["breaker_open"] == 0

    run(main())


# ---------------------------------------------------------------------------
# HTTP server + client
# ---------------------------------------------------------------------------

def test_http_client_roundtrip(pack_paths):
    local = Trace.open(pack_paths, device="cpu").query().flat_profile()
    windowed = (Trace.open(pack_paths[0], device="cpu").query()
                .slice_time(0.0, 30.0, trim="within").time_profile())

    async def main():
        server = await TraceServer(service(), port=0).start()

        def client_work():
            with ServiceClient("127.0.0.1", server.port,
                               tenant="alice") as c:
                assert c.health()["ok"]
                assert {o["name"] for o in c.ops()} >= {"flat_profile",
                                                        "stragglers"}
                trace = c.open(pack_paths, streaming=True)
                prof = trace.query().flat_profile()
                w = (c.open(pack_paths[0]).query()
                     .slice_time(0.0, 30.0, trim="within").time_profile())
                dig = trace.query().flat_profile(digest_only=True)
                with pytest.raises(RemoteError) as exc:
                    trace.query().run("no_such_op")
                assert exc.value.status == 400
                for path in ("/setquery", "/diagnose"):
                    with pytest.raises(RemoteError) as exc:
                        c._request("POST", path, {})
                    assert exc.value.status == 400
                diff = c.open_set(pack_paths[:2]).query().diff_flat_profile()
                diag = trace.diagnose()
                return prof, w, dig, c.stats(), diff, diag

        result = await asyncio.to_thread(client_work)
        await server.shutdown(grace=5)
        return result

    prof, w, dig, stats, diff, diag = run(main())
    assert result_digest(prof) == result_digest(local) == dig
    assert result_digest(w) == result_digest(windowed)
    assert result_digest(diff) == result_digest(
        TraceSet.open(pack_paths[:2], device="cpu").diff_flat_profile())
    assert result_digest(diag) == result_digest(
        Trace.open(pack_paths, streaming=True, device="cpu").diagnose())
    assert stats["service"]["requests"] >= 4 and "alice" in stats["tenants"]
    assert stats["device"] == "cpu"


def test_http_live_and_liveset_polls(tmp_path):
    """``open_live(...).poll()`` goes 200, 429 ``watermark_stalled`` with
    ``retry_after_ms``, 200 after a commit; ``open_liveset`` answers 206
    partial naming the back-dated rank."""
    from repro_torch.runtime.tracer import Tracer, write_heartbeat
    tracers = []
    for r in range(3):
        tr = Tracer(process=r, sink=str(tmp_path / f"rank_{r}.pack"),
                    flush_every=40, fsync=False)
        for i in range(60):
            with tr.span(f"fn{i % 5}", proc=r):
                pass
        tr.flush()
        tracers.append(tr)
    write_heartbeat(str(tmp_path / "rank_2.pack"), 2, 120, 1, 9,
                    wall=time.time() - 120.0)

    async def main():
        server = await TraceServer(service(), port=0).start()

        def client_work():
            with ServiceClient("127.0.0.1", server.port, tenant="t") as c:
                live = c.open_live(str(tmp_path / "rank_0.pack"))
                first = live.poll("flat_profile")
                with pytest.raises(RemoteError) as stalled:
                    live.poll("flat_profile")
                for _ in range(20):
                    tracers[0].instant("tick", proc=0)
                tracers[0].flush()
                third = live.poll("flat_profile")
                fleet = c.open_liveset(str(tmp_path), lag_timeout=5.0,
                                       dead_timeout=60.0)
                part = fleet.poll("flat_profile", min_advance_rows=0)
                return first, stalled.value, third, part

        result = await asyncio.to_thread(client_work)
        await server.shutdown(grace=5)
        return result

    first, stalled, third, part = run(main())
    assert first["watermark"]["rows"] == 120
    assert stalled.status == 429 and stalled.code == "watermark_stalled"
    assert stalled.extra["retry_after_ms"] > 0
    assert third["watermark"]["rows"] == 140 and third["advanced_rows"] == 20
    assert part["partial"] and part["missing_ranks"] == [2]
    assert len(part["value"]) > 0


def test_service_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        TraceService()


# ---------------------------------------------------------------------------
# the kernel layer under lane threads
# ---------------------------------------------------------------------------

def test_library_builds_once_under_concurrent_first_calls(monkeypatch):
    """Eight threads make the first kernel call at once: one build, one
    load, one library for all."""
    builds, loads = [], []

    def fake_build():
        builds.append(threading.get_ident())
        time.sleep(0.05)
        return "libpipit_kernels_fake.so"

    def fake_cdll(path):
        loads.append(path)
        return types.SimpleNamespace(**{n: types.SimpleNamespace()
                                        for n in build.SIGNATURES})

    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "build", fake_build)
    monkeypatch.setattr(build.ctypes, "CDLL", fake_cdll)
    out, start = [], threading.Barrier(8)

    def first_call():
        start.wait(timeout=10)
        out.append(build.library())

    threads = [threading.Thread(target=first_call) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1 and len(loads) == 1
    assert len(out) == 8 and all(lib is out[0] for lib in out)


def test_launch_counters_lose_no_update():
    """The counters' read-modify-write under the lock: 8 threads x 2,000
    bumps, a short switch interval, no update lost."""
    import sys
    before = hist_bin.LAUNCHES
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def bump():
            for _ in range(2000):
                with build.COUNT_LOCK:
                    hist_bin.LAUNCHES += 1

        threads = [threading.Thread(target=bump) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
        delta = hist_bin.LAUNCHES - before
        hist_bin.LAUNCHES = before
    assert not any(t.is_alive() for t in threads)
    assert delta == 16_000


def test_lane_threads_give_the_serial_bits(pack_paths):
    """The seven op calls from 4 lane threads at once (cache off): each
    thread's results are the serial results' bits."""
    serial = [digest(Trace.open(pack_paths, streaming=True, cache=False,
                                device="cpu").run(op, **kw))
              for op, kw in TERMINALS]

    def calls():
        h = Trace.open(pack_paths, streaming=True, cache=False,
                       device="cpu")
        return [digest(h.run(op, **kw)) for op, kw in TERMINALS]

    lane = get_scheduler().lane("bulk")
    futures = [lane.submit(calls) for _ in range(4)]
    assert all(f.result(timeout=120) == serial for f in futures)
