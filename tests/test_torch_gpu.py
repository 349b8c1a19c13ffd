"""The port's CUDA kernels on the card (marker ``gpu``; they skip on a
machine without CUDA, where the kernels cannot run).

Run on a GPU machine with::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain PyTorch version on the same CUDA
tensors (sums: rtol 1e-4 plus 1e-6 x the largest magnitude, the f32
accumulation gate; counts exact) and must give bit-identical output on a
second launch; the five ops on the card must match the CPU path.  The
model kernels are held to their plain versions as ``tests/test_kernels.py``
holds the Pallas kernels: flash attention within 2e-5 in float32 and 3e-2
in bfloat16, top-k indices exact and gates within 1e-6.  Flash attention in
bfloat16 at D = 64, 96 or 128 runs the tensor-core kernel (``"wgmma"``),
whose cases below cover the three head dims, lengths that are not
multiples of 64 or 128, GQA, window + prefix with an offset, non-causal,
one query row, the serving shape and phi-3-vision's prefill at D = 96;
each bfloat16 case at D = 96 also runs the SIMT kernel, its yardstick.  ``pair_sum`` runs both of its paths (per-warp
shared-memory copies, and sorted runs) on each side of the private path's
threshold, and so do ``seg_sum`` and ``time_bin`` (``time_bin`` also on
NaN and infinite coordinates, where both paths equal its plain version);
the fused router (``router_topk``) runs at the serving model's
prefill and decode shapes, its indices and gates equal to
``topk_gating_plain`` on its own logits and its logits within
``router_topk.logit_tolerance`` of the float32 product.  ``hist_bin`` and
``topk_gating`` run both of their paths (narrow and wide) on the same
inputs, counts exact and top-k bits equal between the paths, on edge
values (+inf, 3e9, -0.0 and NaN coordinates; rows of -inf and of values
at or below -1e30, which select a chosen column again) and on inputs that
start off the 16-byte boundary.  The two router wrappers are
differentiable on both routes: one backward launches the router's backward
kernel (``topk_gating_bwd``) once, which is held to its plain version on
duplicate columns, strided gradients and T = 0.  Flash attention's backward kernel is held to its plain
version at the training shape and the edge cases (bit-identical on
relaunch), each bfloat16 case at D = 64, 96 or 128 through both of its
variants (``"wgmma"``, the tensor cores, and ``"simt"``; phi-3-vision's
training shape among them), the forward's
row log-sum-exp to the plain one; a failed backward launch of either
variant and an unaligned q, k, v or o under ``"wgmma"`` raise (an
unaligned dO is copied once, to the same bits); a training step of
pipit-lm-100m-smoke on the card runs no plain version, and in bfloat16
at head dim 64 launches only the ``"wgmma"`` backward.  The lazy query and streaming routes give, on the card,
the same bits as the in-memory route on the same selection for each of
the six kernel-backed ops (``stragglers`` among them), and
``stragglers`` on the card matches the CPU path within the gate.  So do
the pack routes (eager, streamed, row-span work units, ``scan``) and the
jsonl work units; a real spawn pool, driven from a script on disk, gives
the eager bits while no worker initializes CUDA; and a read-only mapped
column reaches the card without a warning.  The seven op calls from 4
threads give the serial bits and 4 times its launches; the live route
(incremental, cold, eager) and the served route give the eager and library
bits, and their cache hits launch nothing.  The five set ops of
``core/diff.py`` on the card match the CPU route within the gate, carry
each member's own op bits and launch each record kernel once a member;
streamed sets give the eager set's bits; each pathology's detector names
the ground truth at top 1 on the card, ``diagnose`` matches the CPU
route and gives the eager digest on every route; ``/setquery`` and
``/diagnose`` give the library's digests and repeats launch nothing.
``multirun_analysis`` on the card is within the gate of the CPU route with
one ``seg_sum`` launch per run, and the twelve host-op calls of the rest
of the analysis API launch nothing and give the CPU trace's bits.  The
tensor-core flash kernel also runs gemma3-27b's local shape (H 32 over
KVH 16, D = 128, window 1,024) and hymba-1.5b's (H 25 over KVH 5, D =
64, window 1,024 + 128 prefix keys); gemma3, hymba and mamba2 at smoke
size serve the CPU's greedy tokens on the card.  Flash attention at head
dim 96 (phi-3-vision's, the SIMT kernel in both dtypes, forward and
backward) and at whisper-medium's shapes (the encoder over 1,500 frames
non-causal, cross-attention from 448 and from 1 query row over them)
meets the same gates, and whisper and phi-3-vision at smoke size, given
their frames or image embeddings, serve the CPU's greedy tokens on the
card with one flash launch a layer with attention a wave (whisper's
cross-attention also every decode step).  The flash kernels run at
qwen3-moe-235b-a22b's and qwen1.5-110b's groupings (H 64 over KVH 4 and
8, D = 128) in both dtypes and the fused router at its limits (E = 128,
k = 8, d = 4,096, tied rows); on a (1, 1) NCCL mesh the smoke configs'
sharded prefill and decode cells serve the engine's greedy tokens with
its flash launches, and the model-kernel wrappers refuse a DTensor.
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch import Trace
from repro_torch.core import NAME, Filter, plancache
from repro_torch.core.query import scan
from repro_torch.kernels import (flash_attention, hist_bin, pair_sum,
                                 router_topk, seg_sum, time_bin, topk_gating)
from repro_torch.launch.cardcheck import (digest, findings_gate,
                                         flash_bwd_tol, flash_draw,
                                         flash_forward_lse, flash_gate_share,
                                         gate, same_bits, set_gate,
                                         topk_bwd_err)
from repro_torch.tracegen import big_events, big_trace

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def fresh_plan_cache():
    """An empty plan cache around each test: a stored result must not
    answer another test's call (and launch nothing)."""
    plancache.clear()
    yield
    plancache.clear()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only there")
    return torch.device("cuda")


def _close(a, b):
    """Within the gate (``cardcheck.gate``): NaN only where the plain
    version has NaN, and the scale taken over its finite values."""
    gate(a, b)


def _check(kernel, plain, args, exact=False):
    got, again, want = kernel(*args), kernel(*args), plain(*args)
    assert same_bits(got, again), "relaunch not bit-identical"
    if exact:
        assert torch.equal(got.cpu(), want.cpu())
    else:
        _close(got, want)


@pytest.mark.parametrize("n,n_seg,k", [(1, 3, 1), (1000, 7, 2),
                                       (300_000, 1024, 2)])
def test_seg_sum_kernel(cuda, n, n_seg, k):
    rng = np.random.default_rng(n)
    code = torch.from_numpy(rng.integers(-1, n_seg, n).astype(np.int32))
    vals = torch.from_numpy(rng.random((n, k)).astype(np.float32) * 1e4)
    before = seg_sum.LAUNCHES
    _check(seg_sum.seg_sum, seg_sum.seg_sum_plain,
           (code.to(cuda), vals.to(cuda), n_seg))
    assert seg_sum.LAUNCHES == before + 2


@pytest.mark.parametrize("n,n_a,n_b", [(1, 2, 2), (1000, 5, 7),
                                       (300_000, 1024, 1024)])
def test_pair_sum_kernel(cuda, n, n_a, n_b):
    rng = np.random.default_rng(n)
    a = torch.from_numpy(rng.integers(-1, n_a, n).astype(np.int32))
    b = torch.from_numpy(rng.integers(0, n_b, n).astype(np.int32))
    w = torch.from_numpy(rng.random(n).astype(np.float32) * 1e4)
    _check(pair_sum.pair_sum, pair_sum.pair_sum_plain,
           (a.to(cuda), b.to(cuda), w.to(cuda), n_a, n_b))


@pytest.mark.parametrize("n,n_funcs,n_bins", [(1, 2, 4), (1000, 7, 10),
                                              (300_000, 13, 32)])
def test_time_bin_kernel(cuda, n, n_funcs, n_bins):
    rng = np.random.default_rng(n)
    s = rng.random(n) * n_bins
    e = np.minimum(s + rng.exponential(0.05, n), n_bins)
    e[::7] = s[::7]
    f = rng.integers(-1, n_funcs, n).astype(np.int32)
    r = rng.random(n)
    args = [torch.from_numpy(x.astype(np.float32)).to(cuda)
            for x in (s, e)] + [torch.from_numpy(f).to(cuda),
                                torch.from_numpy(r.astype(np.float32))
                                .to(cuda)]
    _check(time_bin.time_bin, time_bin.time_bin_plain,
           (*args, n_funcs, n_bins, 0.0, float(n_bins)))


@pytest.mark.parametrize("n,n_bins", [(1, 1), (1000, 7), (300_000, 1024),
                                      (300_000, 20_000)])
def test_hist_bin_kernel(cuda, n, n_bins):
    rng = np.random.default_rng(n)
    x = (rng.integers(0, n_bins, n) + 0.5).astype(np.float32)
    x[::13] = -1.0
    _check(hist_bin.hist_bin, hist_bin.hist_bin_plain,
           (torch.from_numpy(x).to(cuda), n_bins), exact=True)


def test_ops_on_card_match_cpu_path(cuda):
    t = Trace.from_events(big_events(nprocs=8, events_per_proc=20_000,
                                     seed=4), device=cuda)
    counts, edges = t.message_histogram()
    cpu_counts, cpu_edges = t.message_histogram(device="cpu")
    assert np.array_equal(counts, cpu_counts)
    assert np.array_equal(edges, cpu_edges)
    np.testing.assert_allclose(t.comm_matrix(), t.comm_matrix(device="cpu"),
                               rtol=1e-4)
    a = t.flat_profile(metrics=("time.exc", "time.inc"))
    b = t.flat_profile(metrics=("time.exc", "time.inc"), device="cpu")
    assert list(a["Name"]) == list(b["Name"])
    assert np.array_equal(a["count"], b["count"])
    np.testing.assert_allclose(a["time.inc"], b["time.inc"], rtol=1e-4)
    p = t.time_profile(num_bins=16)
    q = t.time_profile(num_bins=16, device="cpu")
    assert sorted(p.columns) == sorted(q.columns)
    for c in q.columns:
        np.testing.assert_allclose(p[c], q[c], rtol=1e-4,
                                   atol=1e-6 * float(np.abs(q[c]).max()))


ROUTE_OPS = [
    ("flat_profile", {"metrics": ("time.exc", "time.inc")}),
    ("flat_profile", {"per_process": True}),
    ("time_profile", {"num_bins": 16}),
    ("load_imbalance", {}),
    ("comm_matrix", {}),
    ("message_histogram", {"bins": 10}),
    ("stragglers", {"threshold": -1.0}),
]
ROUTE_IDS = [f"{op}-{i}" for i, (op, _) in enumerate(ROUTE_OPS)]


def _drop_halo(q):
    return q.filter(Filter(NAME, "not-in", ["halo_exchange()"]))


@pytest.mark.parametrize("op,kw", ROUTE_OPS, ids=ROUTE_IDS)
def test_query_plan_on_card_equals_eager_selection(cuda, op, kw):
    """A plan (remap or recompute, then an op) gives on the card the bits
    of the same selection made eagerly and reduced on the card."""
    t = Trace.from_events(big_events(nprocs=8, events_per_proc=20_000,
                                     seed=4), device=cuda)
    t._ensure_structure()
    got = _drop_halo(t.query()).run(op, **kw)
    eager = _drop_halo(t.query()).collect()
    assert eager.device == cuda
    assert digest(got) == digest(eager.run(op, **kw))
    sub = t.query().restrict_processes(range(4)).collect()
    if op != "comm_matrix":        # rank 3 sends to rank 4, cut out
        assert digest(t.query().restrict_processes(range(4)).run(op, **kw)) \
            == digest(sub.run(op, **kw))


def test_stragglers_on_card_match_cpu_path(cuda):
    t = Trace.from_events(big_events(nprocs=64, events_per_proc=2_000,
                                     seed=4), device=cuda)
    before = dict(seg_sum.PATH_LAUNCHES)
    a = t.stragglers(threshold=-1.0)
    assert seg_sum.PATH_LAUNCHES["private"] == before["private"] + 1
    b = t.stragglers(threshold=-1.0, device="cpu")
    assert sorted(np.asarray(a["process"])) == list(range(64))
    ka, kb = np.argsort(np.asarray(a["process"])), \
        np.argsort(np.asarray(b["process"]))
    for c in ("t_start", "t_end"):
        assert np.array_equal(np.asarray(a[c])[ka], np.asarray(b[c])[kb])
    gate(np.asarray(a["severity"])[ka], np.asarray(b["severity"])[kb])


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    return big_trace(str(tmp_path_factory.mktemp("card_stream")), nprocs=8,
                     events_per_proc=4_000, calls_per_iter=50, seed=2)


@pytest.mark.parametrize("op,kw", ROUTE_OPS, ids=ROUTE_IDS)
@pytest.mark.parametrize("chunk_rows", [97, 65_536])
def test_streaming_on_card_equals_eager(cuda, shards, chunk_rows, op, kw):
    st = Trace.open(shards, streaming=True, chunk_rows=chunk_rows)
    assert st.device.type == "cuda"
    eager = Trace.open(shards)
    assert digest(st.run(op, **kw)) == digest(eager.run(op, **kw))


@pytest.fixture(scope="module")
def pack_shards(tmp_path_factory):
    return big_trace(str(tmp_path_factory.mktemp("card_pack")), nprocs=8,
                     events_per_proc=4_000, calls_per_iter=50, seed=2,
                     format="pack")


def _units(paths, op, kw, n_units):
    from repro_torch.core import executor, registry
    from repro_torch.core.streaming import StreamingTrace
    h = StreamingTrace(paths, chunk_rows=997, processes=2)
    spec = registry.get_op(op)
    kw = dict(kw, device=h.device)
    return executor.execute_parallel(h, (), spec, (), kw,
                                     spec.streaming(**kw), n_units=n_units,
                                     use_pool=False)


PACK_ROUTES = {
    "pack-eager": lambda s, p, op, kw: Trace.open(p).run(op, **kw),
    "pack-streamed": lambda s, p, op, kw: Trace.open(
        p, streaming=True, chunk_rows=997).run(op, **kw),
    "pack-units": lambda s, p, op, kw: _units(p, op, kw, 19),
    "jsonl-units": lambda s, p, op, kw: _units(s, op, kw, 19),
    "scan": lambda s, p, op, kw: scan(p).run(op, **kw),
}


@pytest.mark.parametrize("op,kw", ROUTE_OPS, ids=ROUTE_IDS)
@pytest.mark.parametrize("route", list(PACK_ROUTES))
def test_pack_and_parallel_routes_on_card_equal_eager(cuda, shards,
                                                      pack_shards, route,
                                                      op, kw):
    """The pack routes (eager, streamed, row-span units, ``scan``) and the
    jsonl work units give on the card the eager jsonl route's bits."""
    want = digest(Trace.open(shards).run(op, **kw))
    assert digest(PACK_ROUTES[route](shards, pack_shards, op, kw)) == want


_POOL_SCRIPT = """
import sys, warnings
sys.path.insert(0, {src!r})
import torch
from repro_torch import Trace
from repro_torch.launch.cardcheck import digest


def main():
    warnings.simplefilter("error", RuntimeWarning)  # no degradation
    st = Trace.open({paths!r}, streaming=True, chunk_rows=997, processes=2)
    eager = Trace.open({paths!r})
    for op, kw in {ops!r}:
        assert digest(st.run(op, **kw)) == digest(eager.run(op, **kw)), op
        assert len(st.units_cuda) >= 2
        assert not any(st.units_cuda), st.units_cuda
    assert torch.cuda.is_initialized()  # the parent ran the kernels
    st._pool.close()
    print("POOLED")


if __name__ == "__main__":
    main()
"""


def test_pooled_workers_never_initialize_cuda(cuda, pack_shards, tmp_path):
    """A real spawn pool over pack shards from a script on disk: each op
    the eager bits on the card, and every worker reports
    ``torch.cuda.is_initialized()`` false."""
    import os
    import subprocess
    import sys
    import textwrap
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    script = tmp_path / "run_pool.py"
    script.write_text(textwrap.dedent(_POOL_SCRIPT.format(
        src=src, paths=pack_shards, ops=ROUTE_OPS)))
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("POOLED")


TRACE_MODS = (seg_sum, pair_sum, time_bin, hist_bin)


def _launches():
    return sum(m.LAUNCHES for m in TRACE_MODS)


def test_lane_threads_give_the_serial_bits_and_launches(cuda, pack_shards):
    """The seven op calls from 4 threads at once on the card (cache off):
    every thread's results are the serial bits, and the kernels launched 4
    times the serial count (the counters lose no update)."""
    import threading

    def calls(out):
        h = Trace.open(pack_shards, streaming=True, cache=False)
        out.extend(digest(h.run(op, **kw)) for op, kw in ROUTE_OPS)

    serial = []
    before = _launches()
    calls(serial)
    once = _launches() - before
    outs = [[] for _ in range(4)]
    threads = [threading.Thread(target=calls, args=(o,)) for o in outs]
    before = _launches()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert all(o == serial for o in outs)
    assert once > 0 and _launches() - before == 4 * once


def _grow_live(d, paths, frac):
    """The first ``frac`` of each pack shard's rows (in whole groups of 512)
    on a live shard of the same rank under ``d``, one commit each, sealed
    at ``frac`` 1; returns the live paths."""
    from repro_torch.readers.pack import PackWriter
    out = []
    for r, p in enumerate(paths):
        ev = Trace.open(p, device="cpu").events
        lp = str(d / f"rank_{r}.pack")
        w = PackWriter.open_append(lp, chunk_rows=512, fsync=False)
        have = w.watermark["rows"]
        hi = int(len(ev) * frac) // 512 * 512 if frac < 1 else len(ev)
        if hi > have:
            w.append(ev.take(np.arange(have, hi)))
        w.commit()
        if frac >= 1:
            w.finalize(sidecar=False)
        out.append(lp)
    return out


def test_live_route_on_card_incremental_cold_eager(cuda, pack_shards,
                                                   tmp_path):
    """Live shards grown in two commits: at each watermark every op's
    incremental result (cache on) is the bits of a cold ``cache=False``
    handle and of the eager route over the same rows; after finalize, the
    eager pack route's bits; a repeat with no growth launches nothing."""
    from repro_torch.core import streaming
    lt = None
    fallbacks = streaming.INCREMENTAL_FALLBACKS
    for frac in (0.5, 1.0):
        live = _grow_live(tmp_path, pack_shards, frac)
        if lt is None:
            lt = Trace.open(live, live=True, chunk_rows=997)
        lt.refresh()
        eager = lt.materialize()
        for op, kw in ROUTE_OPS:
            inc = digest(lt.run(op, **kw))
            cold = digest(Trace.open(live, live=True, chunk_rows=997,
                                     cache=False).run(op, **kw))
            assert inc == cold == digest(eager.run(op, **kw)), (op, frac)
    assert lt.watermark.finalized
    for op, kw in ROUTE_OPS:
        assert digest(lt.run(op, **kw)) == digest(
            Trace.open(pack_shards).run(op, **kw))
    before = _launches()
    for op, kw in ROUTE_OPS:
        lt.run(op, **kw)
    assert _launches() == before
    assert streaming.INCREMENTAL_FALLBACKS == fallbacks


def test_served_route_on_card_equals_library(cuda, pack_shards):
    """Each op through the service on the card: the library call's bits on
    the same handle configuration; a repeat launches nothing."""
    import asyncio

    from repro_torch.serving import protocol
    from repro_torch.serving.tracequery import TraceService
    svc = TraceService()
    for op, kw in ROUTE_OPS:
        body = {"open": {"paths": list(pack_shards), "streaming": True},
                "op": op, "kwargs": {k: protocol.encode_value(v)
                                     for k, v in kw.items()}}
        out = asyncio.run(svc.query(body))
        lib = Trace.open(pack_shards, streaming=True, cache=False).run(
            op, **kw)
        assert out["digest"] == protocol.result_digest(lib), op
        before = _launches()
        again = asyncio.run(svc.query(body))
        assert again["cached"] and _launches() == before


# ---------------------------------------------------------------------------
# sets (core/diff.py) and the detector suite on the card
# ---------------------------------------------------------------------------

SET_OPS = ["diff_flat_profile", "regression_report", "scaling_analysis",
           "diff_time_profile", "diff_load_imbalance"]


def _per_kernel():
    return {m.__name__.rsplit(".", 1)[1]: m.LAUNCHES for m in TRACE_MODS}


def test_set_ops_on_card_match_cpu_and_carry_member_bits(cuda):
    """The five set ops over two in-memory traces on the card: within the
    gate of the CPU route; each member's column is that member's own op
    on the card, bit for bit; the launches are one per member and kernel
    (the profile cache answers the other two ``flat_profile`` passes), and
    a trace op mapped over the set launches ``hist_bin`` once a member."""
    from repro_torch import TraceSet
    a = Trace.from_events(big_events(nprocs=8, events_per_proc=8_000,
                                     seed=3), device=cuda)
    b = Trace.from_events(big_events(nprocs=4, events_per_proc=16_000,
                                     seed=4), device=cuda)
    ts = TraceSet([a, b], labels=["n8", "n4"])
    for t in ts:
        t._ensure_structure()
    before = _per_kernel()
    card = {op: ts.run(op) for op in SET_OPS}
    mapped = ts.message_histogram()
    after = _per_kernel()
    assert {k: after[k] - before[k] for k in after} == {
        "seg_sum": 2, "pair_sum": 2, "time_bin": 2, "hist_bin": 2}
    for op in SET_OPS:
        set_gate(op, card[op], ts.run(op, device="cpu"),
                 member_scale=None if op != "diff_time_profile" else max(
                     float(np.abs(np.asarray(p[c])).max())
                     for t in ts for p in [t.time_profile()]
                     for c in p.columns if not c.startswith("bin_")))
    for lbl, t in zip(("n8", "n4"), ts):
        prof = t.flat_profile(metrics=["time.exc"])
        own = dict(zip(map(str, prof["Name"]), np.asarray(prof["time.exc"])))
        d = card["diff_flat_profile"]
        col = dict(zip(map(str, d["Name"]), np.asarray(d[f"time.exc|{lbl}"])))
        assert all(own[k] == v for k, v in col.items() if k in own), lbl
        imb = t.load_imbalance()
        own = dict(zip(map(str, imb["Name"]),
                       np.asarray(imb["time.exc.imbalance"])))
        d = card["diff_load_imbalance"]
        col = dict(zip(map(str, d["Name"]),
                       np.asarray(d[f"imbalance|{lbl}"])))
        assert all(own[k] == v for k, v in col.items() if k in own), lbl
    assert [digest(h) for h in mapped] == [digest(t.message_histogram())
                                           for t in ts]


def test_streaming_set_on_card_equals_eager(cuda, shards):
    """A streamed set (all eight ranks, then the first four) gives on the
    card the eager set's bits."""
    from repro_torch import TraceSet
    members = [shards, shards[:4]]
    st = TraceSet.open(members, streaming=True, chunk_rows=997,
                       labels=["n8", "n4"])
    eager = TraceSet.open(members, labels=["n8", "n4"])
    for op in ("regression_report", "diff_time_profile", "scaling_analysis",
               "diff_load_imbalance"):
        assert digest(st.run(op)) == digest(eager.run(op)), op


@pytest.mark.parametrize("pathology", ["late_sender", "straggler",
                                       "serialization", "imbalance",
                                       "efficiency_drop"])
def test_pathologies_recovered_on_card(cuda, pathology):
    """Each pathology's detector names the ground truth at top 1 on the
    card; ``diagnose`` on the card equals the CPU route (the host
    detectors exactly, ``stragglers`` within the gate) and launches
    ``seg_sum`` once."""
    from repro_torch.tracegen import PATHOLOGIES, pathology_trace
    tr, gt = pathology_trace(pathology, nprocs=8, iters=64,
                             magnitude=4.0 if pathology != "efficiency_drop"
                             else 0.6, seed=1)
    top = tr.run(PATHOLOGIES[pathology])
    assert str(top["detector"][0]) == gt.detector
    if gt.process != -1:
        assert int(top["process"][0]) == gt.process
    if gt.function:
        assert str(top["function"][0]) == gt.function
    assert top["t_start"][0] < gt.t_end and top["t_end"][0] > gt.t_start
    before = seg_sum.LAUNCHES
    card = tr.diagnose()
    assert seg_sum.LAUNCHES - before == 1
    findings_gate(card, tr.diagnose(device="cpu"))


def test_diagnose_routes_on_card_equal_eager(cuda, shards, pack_shards):
    """``diagnose`` streamed, over work units, from pack and streamed pack
    gives on the card the eager route's digest."""
    want = digest(Trace.open(shards).diagnose())
    assert digest(Trace.open(shards, streaming=True,
                             chunk_rows=997).diagnose()) == want
    assert digest(_units(shards, "diagnose", {}, 7)) == want
    assert digest(Trace.open(pack_shards).diagnose()) == want
    assert digest(Trace.open(pack_shards, streaming=True).diagnose()) == want


def test_served_set_and_diagnose_on_card(cuda, pack_shards):
    """``/setquery`` (members of shard lists) and ``/diagnose`` on the
    card: the library's digests; a repeat is a cache hit and launches
    nothing."""
    import asyncio

    from repro_torch import TraceSet
    from repro_torch.serving import protocol
    from repro_torch.serving.tracequery import TraceService
    svc = TraceService()
    members = [list(pack_shards), list(pack_shards[:4])]
    body = {"open": {"mode": "set", "paths": members, "streaming": True,
                     "labels": ["n8", "n4"]}, "op": "regression_report"}
    out = asyncio.run(svc.query(body, set_scope=True))
    lib = TraceSet.open(members, streaming=True, labels=["n8", "n4"],
                        cache=False).regression_report()
    assert out["digest"] == protocol.result_digest(lib)
    diag = {"open": {"paths": list(pack_shards), "streaming": True},
            "op": "diagnose"}
    out = asyncio.run(svc.query(diag))
    lib = Trace.open(pack_shards, streaming=True, cache=False).diagnose()
    assert out["digest"] == protocol.result_digest(lib)
    before = _launches()
    assert asyncio.run(svc.query(body, set_scope=True))["cached"]
    assert asyncio.run(svc.query(diag))["cached"]
    assert _launches() == before


def test_read_only_arrays_reach_the_card_without_a_warning(cuda,
                                                           pack_shards):
    import warnings

    from repro_torch.core import accel
    from repro_torch.readers import pack
    footer = pack.read_footer(pack_shards[0])
    raw = np.memmap(pack_shards[0], dtype=np.uint8, mode="r")
    ch = footer["chunks"][0]
    off = ch["offset"]
    cols = {}
    for key, dt, nb in ch["cols"]:
        cols[key] = raw[off:off + nb].view(dt)
        off += nb
    codes = cols["name"]                  # read-only int32, mapped
    vals = np.asarray(cols["ts"] % 1000, np.float32)
    vals.flags.writeable = False          # read-only float32
    assert not codes.flags.writeable
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = accel.seg_sum(codes, vals, len(footer["names"]), device=cuda)
    want = accel.seg_sum(codes, vals, len(footer["names"]), device="cpu")
    gate(got, want)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("B,Sq,Sk,H,KVH,D,kw", [
    (2, 128, 128, 4, 4, 64, {}),                              # causal
    (1, 160, 160, 2, 2, 32, {"window": 64, "prefix_len": 8}),
    (1, 96, 96, 2, 1, 32, {"causal": False}),
    (2, 200, 200, 8, 2, 128, {}),                             # GQA 4
    (1, 1000, 1000, 4, 4, 128, {}),                           # padded tail
    (2, 1, 300, 4, 2, 128, {"q_offset": 299}),                # one query
    (1, 77, 77, 2, 2, 64, {"window": 16}),
    (4, 33, 33, 4, 4, 16, {}),                                # smoke width
    (1, 40, 1300, 4, 2, 64, {"q_offset": 1260, "window": 64,
                             "prefix_len": 8}),
    (2, 50, 70, 4, 4, 32, {"causal": False, "window": 20}),
    # in bf16 on peaked draws (cardcheck.flash_draw): outputs of order
    # one, the gate at most a tenth of their mean magnitude
    (1, 300, 300, 4, 4, 96, {"peaked": True}),                # phi-3: D 96
    (1, 200, 200, 4, 2, 96, {"window": 64, "prefix_len": 8,
                             "peaked": True}),
    (2, 1, 1500, 4, 4, 96, {"causal": False, "peaked": True}),
    (1, 1500, 1500, 2, 2, 64, {"causal": False,               # whisper enc
                               "peaked": True}),
    # qwen3-moe-235b-a22b's H 64 over KVH 4 (a group of 16) and
    # qwen1.5-110b's H 64 over KVH 8, causal at D = 128
    (2, 1024, 1024, 64, 4, 128, {"peaked": True}),
    (2, 1024, 1024, 64, 8, 128, {"peaked": True}),
    (2, 448, 1500, 2, 2, 64, {"causal": False, "peaked": True}),    # cross
    (4, 1, 1500, 4, 4, 64, {"causal": False, "peaked": True}),  # decode
])
def test_flash_attention_kernel(cuda, dtype, tol, B, Sq, Sk, H, KVH, D, kw):
    kw = dict(kw)
    peaked = kw.pop("peaked", False) and dtype == torch.bfloat16
    rng = np.random.default_rng(Sq + Sk + D)
    q, k, v = (torch.from_numpy(a).to(cuda, dtype) for a in flash_draw(
        rng, (B, Sq, H, D), (B, Sk, KVH, D), peaked))
    before = flash_attention.LAUNCHES
    got = flash_attention.flash_attention(q, k, v, **kw)
    again = flash_attention.flash_attention(q, k, v, **kw)
    want = flash_attention.flash_attention_plain(q, k, v, **kw)
    assert flash_attention.LAUNCHES == before + 2
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, again), "relaunch not bit-identical"
    if peaked:
        flash_gate_share(tol, want)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


#: bfloat16 cases at phi-3-vision's head dim 96 (peaked draws, as above):
#: its prefill, window + prefix over GQA with an offset, non-causal at
#: Sq != Sk, one query row, a padded tail
D96_CASES = [
    (4, 1168, 1168, 32, 32, {}),                              # phi-3 prefill
    (1, 40, 1300, 4, 2, {"q_offset": 1260, "window": 64, "prefix_len": 8}),
    (2, 70, 150, 4, 2, {"causal": False}),
    (2, 1, 1500, 4, 4, {"causal": False}),
    (1, 1000, 1000, 4, 4, {}),
]


@pytest.mark.parametrize("name", ["wgmma", "simt"])
@pytest.mark.parametrize("B,Sq,Sk,H,KVH,kw", D96_CASES)
def test_flash_attention_d96_both_variants(cuda, name, B, Sq, Sk, H, KVH,
                                           kw):
    """bfloat16 at D = 96 through the tensor-core kernel (what the wrapper
    picks) and the SIMT one: each within 3e-2 of the plain version,
    bit-identical on relaunch, one launch a call of that variant."""
    rng = np.random.default_rng(Sq * Sk + 96)
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16)
               for a in flash_draw(rng, (B, Sq, H, 96), (B, Sk, KVH, 96),
                                   True))
    assert flash_attention.variant(q.dtype, 96) == "wgmma"
    before = flash_attention.VARIANT_LAUNCHES[name]
    got = flash_attention.flash_attention_variant(name, q, k, v, **kw)
    again = flash_attention.flash_attention_variant(name, q, k, v, **kw)
    want = flash_attention.flash_attention_plain(q, k, v, **kw)
    assert flash_attention.VARIANT_LAUNCHES[name] == before + 2
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert torch.equal(got, again), "relaunch not bit-identical"
    if name == "wgmma":
        assert torch.equal(got, flash_attention.flash_attention(q, k, v,
                                                                **kw))
    flash_gate_share(3e-2, want)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=0)


@pytest.mark.parametrize("B,Sq,Sk,H,KVH,D,kw", [
    (2, 128, 128, 4, 4, 64, {}),                              # D = 64
    (2, 256, 256, 4, 4, 128, {}),                             # D = 128
    (1, 1000, 1000, 4, 4, 128, {}),                           # tails
    (1, 77, 200, 4, 4, 64, {"causal": False}),
    (2, 200, 200, 8, 2, 128, {}),                             # GQA 4
    (2, 300, 300, 8, 2, 64, {}),                              # GQA 4
    (1, 40, 1300, 4, 2, 64, {"q_offset": 1260, "window": 64,
                             "prefix_len": 8}),
    (2, 300, 300, 4, 4, 128, {"q_offset": 5, "window": 100,
                              "prefix_len": 4}),
    (2, 512, 700, 8, 8, 128, {"causal": False}),              # non-causal
    (4, 1, 2000, 16, 16, 128, {"q_offset": 1999}),            # Sq = 1
    (4, 872, 872, 16, 16, 128, {}),                           # serving
    (1, 2048, 2048, 32, 16, 128, {"window": 1024}),           # gemma3
    (1, 1300, 1300, 25, 5, 64, {"window": 1024,               # hymba
                                "prefix_len": 128}),
    # peaked draws, as above
    (4, 1500, 1500, 16, 16, 64, {"causal": False,             # whisper enc
                                 "peaked": True}),
    (4, 448, 1500, 16, 16, 64, {"causal": False, "peaked": True}),  # cross
    (4, 1, 1500, 16, 16, 64, {"causal": False, "peaked": True}),  # decode
])
def test_flash_attention_tensor_core_kernel(cuda, B, Sq, Sk, H, KVH, D, kw):
    kw = dict(kw)
    peaked = kw.pop("peaked", False)
    rng = np.random.default_rng(Sq * Sk + D)
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16)
               for a in flash_draw(rng, (B, Sq, H, D), (B, Sk, KVH, D),
                                   peaked))
    assert flash_attention.variant(q.dtype, D) == "wgmma"
    before = flash_attention.VARIANT_LAUNCHES["wgmma"]
    got = flash_attention.flash_attention(q, k, v, **kw)
    again = flash_attention.flash_attention(q, k, v, **kw)
    want = flash_attention.flash_attention_plain(q, k, v, **kw)
    assert flash_attention.VARIANT_LAUNCHES["wgmma"] == before + 2
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert torch.equal(got, again), "relaunch not bit-identical"
    if peaked:
        flash_gate_share(3e-2, want)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=0)


def test_flash_attention_variants_agree(cuda):
    """The SIMT kernel on the same bf16 inputs: both within the gate of
    the plain version, and the wgmma kernel refuses what it cannot take."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda, torch.bfloat16)
               for s in ((2, 300, 8, 128), (2, 300, 2, 128), (2, 300, 2, 128)))
    want = flash_attention.flash_attention_plain(q, k, v).float()
    for name in ("simt", "wgmma"):
        got = flash_attention.flash_attention_variant(name, q, k, v)
        torch.testing.assert_close(got.float(), want, atol=3e-2, rtol=0)
    with pytest.raises(ValueError):
        flash_attention.flash_attention_variant("wgmma", q.float(),
                                                k.float(), v.float())
    with pytest.raises(ValueError):
        flash_attention.flash_attention_variant("wgmma", q[..., :32]
                                                .contiguous(),
                                                k[..., :32].contiguous(),
                                                v[..., :32].contiguous())


BWD_CASES = [
    (16, 256, 256, 12, 12, 64, {}),                           # training
    (2, 200, 200, 8, 2, 128, {}),                             # GQA 4
    (1, 160, 160, 4, 2, 32, {"window": 64, "prefix_len": 8}),
    (1, 1000, 1000, 4, 4, 128, {}),                           # padded tail
    (2, 33, 33, 4, 4, 16, {}),                                # smoke width
    (1, 40, 1300, 4, 2, 64, {"q_offset": 1260, "window": 64,
                             "prefix_len": 8}),
    (2, 50, 70, 4, 4, 32, {"causal": False}),
    (1, 300, 300, 4, 4, 96, {}),                              # phi-3: D 96
    (2, 70, 150, 4, 2, 96, {"causal": False}),
    (1, 40, 1300, 8, 2, 96, {"q_offset": 1260, "window": 64,
                             "prefix_len": 8}),
    (2, 1168, 1168, 32, 32, 96, {}),                          # phi-3 train
]


def _bwd_inputs(cuda, dtype, B, Sq, Sk, H, KVH, D):
    rng = np.random.default_rng(Sq + Sk + D + H)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(cuda, dtype) for s in ((B, Sq, H, D), (B, Sk, KVH, D),
                                       (B, Sk, KVH, D), (B, Sq, H, D))]


def _bwd_variant_cases():
    """(dtype, case, variant): every case through the kernel the wrapper
    picks, and each bfloat16 case at D = 64, 96 or 128 (the tensor-core
    kernel's head dims) through the SIMT kernel as well."""
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        for case in BWD_CASES:
            picked = flash_attention.variant_bwd(dtype, case[5])
            for name in dict.fromkeys((picked, "simt")):
                out.append(pytest.param(
                    dtype, *case, name,
                    id=f"{str(dtype)[6:]}-{'x'.join(map(str, case[:6]))}"
                       f"-{case[6]}-{name}"))
    return out


@pytest.mark.parametrize("dtype,B,Sq,Sk,H,KVH,D,kw,name",
                         _bwd_variant_cases())
def test_flash_attention_bwd_kernel(cuda, dtype, B, Sq, Sk, H, KVH, D, kw,
                                    name):
    """The backward kernel ``name`` against its plain version on the same
    inputs (the plain forward's output and log-sum-exp), bit-identical on
    relaunch, one launch a call; the variant the wrapper picks gives the
    wrapper's bits."""
    q, k, v, do = _bwd_inputs(cuda, dtype, B, Sq, Sk, H, KVH, D)
    o, lse = flash_attention.flash_attention_plain(q, k, v, return_lse=True,
                                                   **kw)
    o = o.contiguous()          # the plain scan's output is a strided view
    before = (flash_attention.LAUNCHES_BWD,
              flash_attention.VARIANT_LAUNCHES_BWD[name])
    run = functools.partial(flash_attention.flash_attention_bwd_variant,
                            name, q, k, v, o, do, lse, **kw)
    got, again = run(), run()
    want = flash_attention.flash_attention_bwd_plain(q, k, v, o, do, lse,
                                                     **kw)
    torch.cuda.synchronize()
    assert (flash_attention.LAUNCHES_BWD,
            flash_attention.VARIANT_LAUNCHES_BWD[name]) == (
        before[0] + 2, before[1] + 2)
    for g, a, w in zip(got, again, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert same_bits(g, a), "relaunch not bit-identical"
        torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                   atol=flash_bwd_tol(dtype, w))
    if name == flash_attention.variant_bwd(dtype, D):
        picked = flash_attention.flash_attention_bwd(q, k, v, o, do, lse,
                                                     **kw)
        assert all(same_bits(g, p) for g, p in zip(got, picked))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KVH,D,kw", BWD_CASES[:4])
def test_flash_attention_forward_writes_the_lse(cuda, dtype, B, Sq, Sk, H,
                                                KVH, D, kw):
    """The training forward (either variant the wrapper picks) writes each
    row's log-sum-exp: the plain version's within 1e-4 (f32 scores summed
    in another order, on the tensor cores in bf16); its output is the
    serving call's bits."""
    q, k, v, _do = _bwd_inputs(cuda, dtype, B, Sq, Sk, H, KVH, D)
    out, lse = flash_forward_lse(q, k, v, **kw)
    _o, want = flash_attention.flash_attention_plain(q, k, v,
                                                     return_lse=True, **kw)
    torch.testing.assert_close(lse, want, atol=1e-4, rtol=1e-5)
    assert same_bits(out, flash_attention.flash_attention(q, k, v, **kw))


def test_flash_attention_bwd_raises_on_a_failed_launch(cuda, monkeypatch):
    """A backward whose kernel reports an error raises; nothing falls back
    to the plain version."""
    q, k, v, do = _bwd_inputs(cuda, torch.bfloat16, 1, 64, 64, 2, 2, 64)
    q.requires_grad_(True)
    out = flash_attention.flash_attention(q, k, v)
    lib = flash_attention.build.library()

    class Failing:
        def __getattr__(self, name):
            if name == "pipit_flash_attention_bwd":
                return lambda *a: 700
            return getattr(lib, name)

    o, lse = flash_forward_lse(q.detach(), k, v)
    monkeypatch.setattr(flash_attention.build, "library", lambda: Failing())
    monkeypatch.setattr(flash_attention, "flash_attention_bwd_plain",
                        lambda *a, **k: pytest.fail("plain version ran"))
    assert flash_attention.variant_bwd(q.dtype, 64) == "wgmma"
    with pytest.raises(RuntimeError, match="flash_attention_bwd: CUDA "
                                           "error 700"):
        out.backward(do)
    for name in ("wgmma", "simt"):
        with pytest.raises(RuntimeError, match="flash_attention_bwd: CUDA "
                                               "error 700"):
            flash_attention.flash_attention_bwd_variant(
                name, q.detach(), k, v, o, do, lse)
    # an unaligned q, k, v or o: the wgmma kernel's TMA loads refuse it
    args = [q.detach(), k, v, o]
    for i in range(4):
        bad = list(args)
        bad[i] = _unaligned(args[i])
        with pytest.raises(ValueError, match="16-byte aligned"):
            flash_attention.flash_attention_bwd_variant("wgmma", *bad, do,
                                                        lse)


def _unaligned(x):
    """A contiguous copy of ``x`` that starts 2 bytes past a 16-byte
    boundary."""
    buf = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
    y = buf[1:1 + x.numel()].view(x.shape)
    y.copy_(x)
    assert y.is_contiguous() and y.data_ptr() % 16
    return y


def test_flash_attention_bwd_copies_an_unaligned_do(cuda):
    """The wgmma backward copies an unaligned dO (autograd hands one over)
    once, and gives the aligned call's bits."""
    q, k, v, do = _bwd_inputs(cuda, torch.bfloat16, 2, 200, 200, 8, 2, 128)
    o, lse = flash_forward_lse(q, k, v)
    want = flash_attention.flash_attention_bwd_variant("wgmma", q, k, v, o,
                                                       do, lse)
    got = flash_attention.flash_attention_bwd_variant(
        "wgmma", q, k, v, o, _unaligned(do), lse)
    assert all(same_bits(g, w) for g, w in zip(got, want))


def test_train_step_on_the_card_runs_no_plain_version(cuda, monkeypatch,
                                                      tmp_path):
    """Two training steps of pipit-lm-100m-smoke on the card: every plain
    version raises if it is handed a CUDA tensor, the flash forward and
    backward kernels launch once a layer a step, and the loss is finite."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticLMStream
    from repro_torch.runtime import Trainer, TrainLoopConfig

    def refuse(name, orig):
        def plain(*args, **kw):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                raise AssertionError(f"{name} ran on the card")
            return orig(*args, **kw)
        return plain

    for mod, name in ((flash_attention, "flash_attention_plain"),
                      (flash_attention, "flash_attention_bwd_plain"),
                      (router_topk, "router_topk_plain"),
                      (topk_gating, "topk_gating_plain")):
        monkeypatch.setattr(mod, name, refuse(name, getattr(mod, name)))
    cfg = get_smoke_config("pipit-lm-100m")
    tr = Trainer(cfg, TrainLoopConfig(steps=2, warmup_steps=1,
                                      ckpt_dir=str(tmp_path)), device=cuda)
    stream = SyntheticLMStream(cfg.vocab, 4, 64)
    fwd, bwd = flash_attention.LAUNCHES, flash_attention.LAUNCHES_BWD
    out = tr.run(stream)
    stream.close()
    assert (flash_attention.LAUNCHES - fwd,
            flash_attention.LAUNCHES_BWD - bwd) == (2 * cfg.n_layers,
                                                    2 * cfg.n_layers)
    assert np.all(np.isfinite(out["losses"])) and out["steps"] == 2


def test_bf16_train_step_launches_only_the_wgmma_backward(cuda, tmp_path):
    """Two bfloat16 steps of pipit-lm-100m-smoke at head dim 64 (its 16 is
    below the tensor-core kernels' 64): every backward launch is the
    ``"wgmma"`` variant, as is every forward one, and the loss is
    finite."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticLMStream
    from repro_torch.runtime import Trainer, TrainLoopConfig
    cfg = dataclasses.replace(get_smoke_config("pipit-lm-100m"), head_dim=64)
    tr = Trainer(cfg, TrainLoopConfig(steps=2, warmup_steps=1,
                                      ckpt_dir=str(tmp_path),
                                      dtype=torch.bfloat16), device=cuda)
    stream = SyntheticLMStream(cfg.vocab, 4, 64)
    fwd = dict(flash_attention.VARIANT_LAUNCHES)
    bwd = dict(flash_attention.VARIANT_LAUNCHES_BWD)
    out = tr.run(stream)
    stream.close()
    ran = {n: flash_attention.VARIANT_LAUNCHES_BWD[n] - bwd[n] for n in bwd}
    assert ran == {"simt": 0, "wgmma": 2 * cfg.n_layers}
    assert {n: flash_attention.VARIANT_LAUNCHES[n] - fwd[n] for n in fwd} \
        == {"simt": 0, "wgmma": 2 * cfg.n_layers}
    assert np.all(np.isfinite(out["losses"])) and out["steps"] == 2


@pytest.mark.parametrize("arch", ["whisper-medium", "phi-3-vision-4.2b"])
def test_encdec_and_vlm_smoke_serve_on_the_card(cuda, arch):
    """The smoke config in f32 from one seeded weight set, served on the
    card with its frames or image embeddings and on the CPU: the same
    greedy tokens, and on the card one flash launch a layer with
    attention a wave (whisper: its encoder's, its decoder's self- and
    cross-attention in prefill, and cross-attention every decode
    step)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    cfg = get_smoke_config(arch)
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0)).state_dict()
    gen = torch.Generator().manual_seed(1)
    extras = ({"frames": torch.randn(2, cfg.enc_frames, cfg.d_model,
                                     generator=gen)}
              if cfg.family == "encdec" else
              {"img_embeds": torch.randn(2, cfg.img_tokens, cfg.d_model,
                                         generator=gen)})
    new, waves = 5, 2
    out = {}
    for dev in ("cpu", cuda):
        eng = ServeEngine(cfg, batch=2, cache_len=64, params=params,
                          device=dev)
        before = flash_attention.LAUNCHES
        done = eng.serve_queue(make_requests(cfg.vocab, 4, 16, new),
                               **{k: v.to(dev) for k, v in extras.items()})
        out[str(dev)] = ([r.out_tokens for r in done],
                         flash_attention.LAUNCHES - before)
    per_wave = (cfg.enc_layers + 2 * cfg.n_layers
                + cfg.n_layers * (new - 1) if cfg.family == "encdec"
                else cfg.n_layers)
    assert out["cpu"] == (out[str(cuda)][0], 0)
    assert out[str(cuda)][1] == waves * per_wave


@pytest.mark.parametrize("T,E,k", [(4096, 60, 4), (32, 128, 8), (777, 64, 4),
                                   (5, 60, 4), (1000, 300, 2)])
def test_topk_gating_kernel(cuda, T, E, k):
    rng = np.random.default_rng(T + E)
    x = rng.standard_normal((T, E)).astype(np.float32)
    x[::3, 1::2] = 0.25                     # rows with exact ties
    x[1::3] = np.round(x[1::3])
    logits = torch.from_numpy(x).to(cuda)
    before = topk_gating.LAUNCHES
    idx, gates = topk_gating.topk_gating(logits, k)
    idx2, gates2 = topk_gating.topk_gating(logits, k)
    want_idx, want_gates = topk_gating.topk_gating_plain(logits, k)
    assert topk_gating.LAUNCHES == before + 2
    assert torch.equal(idx, idx2) and torch.equal(gates, gates2)
    assert torch.equal(idx.cpu(), want_idx.cpu())
    torch.testing.assert_close(gates, want_gates, atol=1e-6, rtol=0)


def _pair_records(rng, n, n_a, n_b, order=None):
    a = rng.integers(-1, n_a + 1, n).astype(np.int32)   # some out of range
    b = rng.integers(0, n_b, n).astype(np.int32)
    if order == "sorted":            # long runs of one cell, as the ops give
        a, b = np.sort(a), np.sort(b)
    elif order == "one cell":
        a[:], b[:] = n_a - 1, n_b - 1
    w = (rng.random(n) * 1e4).astype(np.float32)
    return [torch.from_numpy(x) for x in (a, b, w)]


@pytest.mark.parametrize("n,n_a,n_b,order", [
    (1, 2, 2, None), (1000, 5, 7, None), (300_000, 6, 64, None),
    (300_000, 6, 64, "sorted"), (100_000, 3, 3, "one cell"),
    (200_000, 12, 64, None),        # the largest grid with mask tables
    (300_000, 64, 64, None), (70_000, 96, 64, None),   # at the threshold
])
@pytest.mark.parametrize("name", ["private", "sorted"])
def test_pair_sum_paths(cuda, n, n_a, n_b, order, name):
    rng = np.random.default_rng(n + n_a)
    a, b, w = (x.to(cuda) for x in _pair_records(rng, n, n_a, n_b, order))
    assert pair_sum.path(n, n_a * n_b) == "private"
    before = pair_sum.PATH_LAUNCHES[name]
    _check(lambda *args: pair_sum.pair_sum_path(name, *args),
           pair_sum.pair_sum_plain, (a, b, w, n_a, n_b))
    assert pair_sum.PATH_LAUNCHES[name] == before + 2


@pytest.mark.parametrize("n,n_a,n_b", [(70_000, 5, 1229), (300_000, 2048,
                                                           2048)])
def test_pair_sum_above_threshold_sorted(cuda, n, n_a, n_b):
    rng = np.random.default_rng(n + n_a)
    a, b, w = (x.to(cuda) for x in _pair_records(rng, n, n_a, n_b))
    assert pair_sum.path(n, n_a * n_b) == "sorted"
    before = pair_sum.PATH_LAUNCHES["sorted"]
    _check(pair_sum.pair_sum, pair_sum.pair_sum_plain, (a, b, w, n_a, n_b))
    assert pair_sum.PATH_LAUNCHES["sorted"] == before + 2
    with pytest.raises(ValueError):
        pair_sum.pair_sum_path("private", a, b, w, n_a, n_b)


def _seg_records(rng, n, n_seg, k, order=None):
    code = rng.integers(-2, n_seg + 2, n).astype(np.int32)  # some ignored
    if order == "runs":              # canonical order's long runs of a code
        code = np.sort(code)
    elif order == "one cell":
        code[:] = n_seg - 1
    vals = (rng.random((n, k)) * 1e4).astype(np.float32)
    return torch.from_numpy(code), torch.from_numpy(vals)


SEG_CASES = [
    (4_681_408, 6, 2, None),        # flat_profile at main-10M
    (300_000, 6, 2, "runs"), (100_000, 3, 2, "one cell"),
    (200_000, 6, 1, None), (200_000, 6, 8, None), (200_000, 6, 11, None),
    (100_000, 9, 3, None), (100_000, 700, 5, None),
    (1, 3, 2, None), (1000, 7, 2, None),
    (300_000, 1024, 1, None),       # grouped by __match_any_sync
    (200_000, 3072, 2, None),       # the threshold, 6,144 cells
]


@pytest.mark.parametrize("n,n_seg,k,order", SEG_CASES)
@pytest.mark.parametrize("name", ["private", "sorted"])
def test_seg_sum_paths(cuda, n, n_seg, k, order, name):
    rng = np.random.default_rng(n + n_seg + k)
    code, vals = (x.to(cuda) for x in _seg_records(rng, n, n_seg, k, order))
    assert seg_sum.path(n, n_seg * k) == "private"
    before = seg_sum.PATH_LAUNCHES[name]
    _check(lambda *args: seg_sum.seg_sum_path(name, *args),
           seg_sum.seg_sum_plain, (code, vals, n_seg))
    assert seg_sum.PATH_LAUNCHES[name] == before + 2


def test_seg_sum_above_threshold_sorted(cuda):
    rng = np.random.default_rng(9)
    code, vals = (x.to(cuda) for x in _seg_records(rng, 100_000, 6145, 1))
    assert seg_sum.path(100_000, 6145) == "sorted"
    before = seg_sum.PATH_LAUNCHES["sorted"]
    _check(seg_sum.seg_sum, seg_sum.seg_sum_plain, (code, vals, 6145))
    assert seg_sum.PATH_LAUNCHES["sorted"] == before + 2
    with pytest.raises(ValueError):
        seg_sum.seg_sum_path("private", code, vals, 6145)


def _time_records(rng, n, n_funcs, n_bins, kind=None):
    """Calls as the trace path gives them (coordinates in bin units, short
    spans, a few long ones; funcs below 0 and at n_funcs and above) and
    the edge cases."""
    s = rng.random(n) * n_bins
    d = rng.exponential(2e-3, n)
    d[rng.random(n) < 0.001] *= 5000            # a few long calls
    if kind == "long":
        d[::3] = rng.random(len(d[::3])) * 3 * n_bins
    if kind == "zero":
        d[::2] = 0.0
    if kind == "edges":                         # whole bins, on bin edges
        s = np.floor(s)
        d = np.floor(rng.random(n) * 4)
    e = np.minimum(s + d, n_bins + 2)
    f = rng.integers(-2, n_funcs + 2, n).astype(np.int32)
    if kind == "runs":                          # canonical order: by start
        o = np.argsort(s, kind="stable")
        s, e = s[o], e[o]
    if kind == "one cell":
        s[:], e[:], f[:] = 0.25, 0.75, n_funcs - 1
    r = rng.integers(1, 40, n).astype(np.float64)
    s, e, r = (x.astype(np.float32) for x in (s, e, r))
    if kind == "nonfinite":
        s[::1001], e[::1003] = -np.inf, np.inf
        s[5::2003], e[7::2003] = np.inf, -np.inf
        s[11::20011] = np.nan
        e[13::30011] = np.nan
        f[11::20011] = f[13::30011] = f[17::40009] = 1   # one row of NaN
        r[17::40009] = np.inf
    return [torch.from_numpy(x) for x in (s, e, f, r)]


TIME_CASES = [
    (4_681_408, 6, 32, None),       # time_profile at main-10M
    (300_000, 6, 32, "runs"), (100_000, 6, 32, "long"),
    (100_000, 6, 32, "zero"), (100_000, 5, 16, "edges"),
    (100_000, 3, 4, "one cell"), (200_000, 6, 32, "nonfinite"),
    (1, 2, 4, None), (1000, 7, 10, None), (50_000, 1, 1, None),
    (100_000, 64, 32, None),        # grouped by __match_any_sync
    (200_000, 48, 128, None),       # the threshold, 6,144 cells
]


@pytest.mark.parametrize("n,n_funcs,n_bins,kind", TIME_CASES)
@pytest.mark.parametrize("name", ["private", "sorted"])
def test_time_bin_paths(cuda, n, n_funcs, n_bins, kind, name):
    rng = np.random.default_rng(n + n_funcs + n_bins)
    args = [x.to(cuda) for x in _time_records(rng, n, n_funcs, n_bins, kind)]
    assert time_bin.path(n, n_funcs * n_bins) == "private"
    before = time_bin.PATH_LAUNCHES[name]
    _check(lambda *a: time_bin.time_bin_path(name, *a),
           time_bin.time_bin_plain,
           (*args, n_funcs, n_bins, 0.0, float(n_bins)))
    assert time_bin.PATH_LAUNCHES[name] == before + 2
    if kind == "nonfinite":
        got = time_bin.time_bin_path(name, *args, n_funcs, n_bins, 0.0,
                                     float(n_bins))
        # the port's rule: NaN in the record's own row only (the reference
        # spreads it over every row; ROADMAP C)
        assert bool(got[1].isnan().all()) and not bool(got[0].isnan().any())


@pytest.mark.parametrize("t0,t1", [(0.3, 7.9), (-1e3, 1e3), (1e7, 1e7 + 64)])
@pytest.mark.parametrize("name", ["private", "sorted"])
def test_time_bin_paths_general_edges(cuda, t0, t1, name):
    """Bins that do not start at 0 in unit steps: the private path's
    candidate bins are exact for any t0 and bin width."""
    rng = np.random.default_rng(3)
    n, n_funcs, n_bins = 100_000, 6, 13
    s = t0 + (rng.random(n) * 1.1 - 0.05) * (t1 - t0)
    e = s + rng.exponential(0.05, n) * (t1 - t0)
    f = rng.integers(0, n_funcs, n).astype(np.int32)
    r = rng.random(n)
    args = [torch.from_numpy(x.astype(np.float32)).to(cuda) for x in (s, e)]
    args += [torch.from_numpy(f).to(cuda),
             torch.from_numpy(r.astype(np.float32)).to(cuda)]
    _check(lambda *a: time_bin.time_bin_path(name, *a),
           time_bin.time_bin_plain, (*args, n_funcs, n_bins, t0, t1))


def test_time_bin_above_threshold_sorted(cuda):
    rng = np.random.default_rng(8)
    args = [x.to(cuda) for x in _time_records(rng, 100_000, 13, 1024,
                                               "nonfinite")]
    assert time_bin.path(100_000, 13 * 1024) == "sorted"
    before = time_bin.PATH_LAUNCHES["sorted"]
    _check(time_bin.time_bin, time_bin.time_bin_plain,
           (*args, 13, 1024, 0.0, 1024.0))
    assert time_bin.PATH_LAUNCHES["sorted"] == before + 2
    with pytest.raises(ValueError):
        time_bin.time_bin_path("private", *args, 13, 1024, 0.0, 1024.0)


@pytest.mark.parametrize("T,d,E,k", [
    (3488, 2048, 60, 4),            # qwen2-moe-a2.7b prefill, one wave
    (4, 2048, 60, 4),               # its decode step
    (256, 2048, 60, 4),             # 16 row tiles: the depth split over
    (257, 2048, 60, 4),             # a cluster of 8 CTAs, and past it
    (777, 256, 128, 8), (4, 1024, 128, 8), (33, 80, 8, 2), (1000, 64, 33, 1),
    (17, 2064, 61, 3),
    (4096, 4096, 128, 8),           # qwen3-moe-235b-a22b prefill, one wave:
    (4, 4096, 128, 8),              # the kernel's limits; its decode step
])
def test_router_topk_kernel(cuda, T, d, E, k):
    rng = np.random.default_rng(T + d + E)
    x = torch.from_numpy(rng.standard_normal((T, d)).astype(np.float32))
    x[::5] = 0.0                        # all-zero logits: every column ties
    w = torch.from_numpy(rng.standard_normal((d, E)).astype(np.float32)
                         * 0.02)
    x, w = x.to(cuda).bfloat16(), w.to(cuda).bfloat16()
    assert router_topk.router_variant(x.dtype, d, E, k) == "fused"
    before = router_topk.LAUNCHES
    logits, idx, gates = router_topk.router_topk(x, w, k)
    again = router_topk.router_topk(x, w, k)
    assert router_topk.LAUNCHES == before + 2
    assert all(torch.equal(p, q) for p, q in zip((logits, idx, gates),
                                                 again))
    want_idx, want_gates = topk_gating.topk_gating_plain(logits, k)
    assert torch.equal(idx, want_idx)
    torch.testing.assert_close(gates, want_gates, atol=1e-6, rtol=0)
    want = x.float() @ w.float()
    assert bool(((logits - want).abs()
                 <= router_topk.logit_tolerance(x, w)).all())
    assert idx[::5].tolist() == [list(range(k))] * len(idx[::5])


def test_router_topk_unfused_route_launches_topk_gating(cuda):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((300, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 60)).astype(np.float32))
    x, w = x.to(cuda), w.to(cuda)
    before = (router_topk.LAUNCHES, topk_gating.LAUNCHES,
              router_topk.VARIANT_CALLS["unfused"])
    logits, idx, gates = router_topk.router_topk(x, w, 4)
    assert (router_topk.LAUNCHES, topk_gating.LAUNCHES,
            router_topk.VARIANT_CALLS["unfused"]) == (
        before[0], before[1] + 1, before[2] + 1)
    want = router_topk.router_topk_plain(x, w, 4)
    torch.testing.assert_close(logits, want[0], atol=1e-5, rtol=0)
    assert torch.equal(idx, want[1])


def _hist_coords(rng, n, n_bins, edges=False):
    x = (rng.integers(0, n_bins, n) + 0.5).astype(np.float32)
    x[::13] = -1.0                                  # ignored
    if edges:            # +inf and 3e9 in the top bin, -0.0 in bin 0, NaN
        x[1::17], x[2::17], x[3::17] = np.inf, 3e9, -0.0
        x[4::17], x[5::17] = np.nan, -np.inf
    return torch.from_numpy(x)


HIST_CASES = [
    (579_328, 10, False),           # message_histogram at main-10M
    (300_000, 32, False), (300_000, 17, False), (300_000, 8, False),
    (100_000, 1, False), (1, 4, False), (3, 7, False), (1001, 7, False),
    (50_001, 10, True), (5, 3, True),
]


@pytest.mark.parametrize("n,n_bins,edges", HIST_CASES)
@pytest.mark.parametrize("name", ["narrow", "wide"])
def test_hist_bin_paths(cuda, n, n_bins, edges, name):
    x = _hist_coords(np.random.default_rng(n + n_bins), n, n_bins,
                     edges).to(cuda)
    assert hist_bin.path(n_bins) == "narrow"
    before = hist_bin.PATH_LAUNCHES[name]
    _check(lambda *a: hist_bin.hist_bin_path(name, *a),
           hist_bin.hist_bin_plain, (x, n_bins), exact=True)
    assert hist_bin.PATH_LAUNCHES[name] == before + 2


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("n", [2, 5, 4097, 70_003])
def test_hist_bin_narrow_unaligned_equals_wide(cuda, offset, n):
    """A slice that starts off the 16-byte boundary: the narrow path's
    scalar head, its vectors and its tail count every record once, the
    same counts as the wide path and the plain version."""
    rng = np.random.default_rng(n + offset)
    x = _hist_coords(rng, n + offset, 10, edges=True).to(cuda)[offset:]
    assert x.data_ptr() % 16
    narrow = hist_bin.hist_bin_path("narrow", x, 10)
    wide = hist_bin.hist_bin_path("wide", x, 10)
    assert torch.equal(narrow, wide)
    assert torch.equal(narrow.cpu(), hist_bin.hist_bin_plain(x, 10).cpu())


def test_hist_bin_above_narrow_is_wide(cuda):
    x = _hist_coords(np.random.default_rng(9), 10_000, 33).to(cuda)
    assert hist_bin.path(33) == "wide"
    before = hist_bin.PATH_LAUNCHES["wide"]
    _check(hist_bin.hist_bin, hist_bin.hist_bin_plain, (x, 33), exact=True)
    assert hist_bin.PATH_LAUNCHES["wide"] == before + 2
    with pytest.raises(ValueError):
        hist_bin.hist_bin_path("narrow", x, 33)


def test_hist_bin_narrow_on_two_streams(cuda):
    """Each stream keeps its own ticket, so calls on two streams at once
    give the counts of calls on one."""
    x = _hist_coords(np.random.default_rng(3), 1_000_000, 10).to(cuda)
    want = hist_bin.hist_bin_plain(x, 10)
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    outs = []
    for _ in range(10):
        for s in (s1, s2):
            with torch.cuda.stream(s):
                outs.append(hist_bin.hist_bin_path("narrow", x, 10))
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for o in outs)


def _topk_logits(rng, T, E, kind=None):
    x = rng.standard_normal((T, E)).astype(np.float32)
    x[::3, 1::2] = 0.25                     # rows with exact ties
    x[1::3] = np.round(x[1::3])             # many tied integers, signed zeros
    x[2::7] = -x[2::7] * 0.0                # rows of +0.0 and -0.0
    if kind == "-inf":
        x[::2] = -np.inf                    # re-selects a chosen column
    elif kind == "-1e30":
        x[::2] = -1e30
        x[1::2] = -3e30 - np.abs(x[1::2]) * 1e30
    return torch.from_numpy(x)


TOPK_CASES = [
    (3488, 60, 4, None),            # the f32 router at the serving widths
    (4096, 60, 4, None), (4099, 60, 4, None), (4, 60, 4, None),
    (1000, 5, 1, None), (1000, 5, 5, None), (777, 33, 4, None),
    (777, 64, 8, None), (513, 127, 8, None), (2048, 128, 8, None),
    (999, 128, 1, None), (300, 60, 4, "-inf"), (300, 61, 8, "-inf"),
    (300, 60, 4, "-1e30"), (300, 128, 8, "-1e30"), (1, 8, 8, None),
]


@pytest.mark.parametrize("T,E,k,kind", TOPK_CASES)
@pytest.mark.parametrize("name", ["narrow", "wide"])
def test_topk_gating_paths(cuda, T, E, k, kind, name):
    logits = _topk_logits(np.random.default_rng(T + E + k), T, E,
                          kind).to(cuda)
    assert topk_gating.path(E) == "narrow"
    before = topk_gating.PATH_LAUNCHES[name]
    idx, gates = topk_gating.topk_gating_path(name, logits, k)
    idx2, gates2 = topk_gating.topk_gating_path(name, logits, k)
    assert topk_gating.PATH_LAUNCHES[name] == before + 2
    assert same_bits(idx, idx2) and same_bits(gates, gates2)
    want_idx, want_gates = topk_gating.topk_gating_plain(logits, k)
    assert torch.equal(idx, want_idx)
    torch.testing.assert_close(gates, want_gates, atol=1e-6, rtol=0)


@pytest.mark.parametrize("T,E,k,kind", TOPK_CASES)
def test_topk_gating_narrow_bits_equal_wide(cuda, T, E, k, kind):
    logits = _topk_logits(np.random.default_rng(T + E + k), T, E,
                          kind).to(cuda)
    narrow = topk_gating.topk_gating_path("narrow", logits, k)
    wide = topk_gating.topk_gating_path("wide", logits, k)
    assert all(same_bits(a, b) for a, b in zip(narrow, wide))


@pytest.mark.parametrize("E", [60, 64, 128])
def test_topk_gating_narrow_unaligned_rows(cuda, E):
    """E % 4 == 0 but the logits start off the 16-byte boundary: the narrow
    path loads scalars, with the same bits as the wide path."""
    full = _topk_logits(np.random.default_rng(E), 501 * E + 1, 1)
    logits = full.to(cuda).flatten()[1:].view(501, E)
    assert logits.data_ptr() % 16
    narrow = topk_gating.topk_gating_path("narrow", logits, 4)
    wide = topk_gating.topk_gating_path("wide", logits, 4)
    assert all(same_bits(a, b) for a, b in zip(narrow, wide))
    assert torch.equal(narrow[0], topk_gating.topk_gating_plain(logits,
                                                                 4)[0])


def test_topk_gating_above_narrow_is_wide(cuda):
    logits = _topk_logits(np.random.default_rng(1), 300, 129).to(cuda)
    assert topk_gating.path(129) == "wide"
    before = topk_gating.PATH_LAUNCHES["wide"]
    idx, _ = topk_gating.topk_gating(logits, 8)
    assert topk_gating.PATH_LAUNCHES["wide"] == before + 1
    assert torch.equal(idx, topk_gating.topk_gating_plain(logits, 8)[0])
    with pytest.raises(ValueError):
        topk_gating.topk_gating_path("narrow", logits, 8)


def _grad_cases(cuda):
    """(name, call, floating inputs) for each CUDA model-kernel wrapper."""
    rng = np.random.default_rng(0)

    def t(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda, dtype)

    q, k, v = (t(1, 64, 2, 64, dtype=torch.bfloat16) for _ in range(3))
    qf, kf, vf = (t(1, 64, 2, 32) for _ in range(3))
    x, w = t(64, 128, dtype=torch.bfloat16), t(128, 60, dtype=torch.bfloat16)
    xf, wf = t(64, 32), t(32, 60)
    logits = t(64, 60)
    return {
        "flash_attention": (flash_attention.flash_attention, (q, k, v)),
        "flash_attention simt": (
            lambda *a: flash_attention.flash_attention_variant("simt", *a),
            (qf, kf, vf)),
        "router_topk fused": (lambda *a: router_topk.router_topk(*a, 4),
                              (x, w)),
        "router_topk unfused": (lambda *a: router_topk.router_topk(*a, 4),
                                (xf, wf)),
        "topk_gating narrow": (lambda a: topk_gating.topk_gating(a, 4),
                               (logits,)),
        "topk_gating wide": (
            lambda a: topk_gating.topk_gating_path("wide", a, 4), (logits,)),
    }


GRAD_CASES = ["router_topk fused", "router_topk unfused",
              "topk_gating narrow", "topk_gating wide"]


@pytest.mark.parametrize("case", ["flash_attention", "flash_attention simt"])
@pytest.mark.parametrize("which", [0, -1])
def test_flash_attention_grad_runs_the_backward_kernel(cuda, case, which):
    """With grad enabled and an input that requires grad, the CUDA flash
    wrapper (either variant) returns an output with a grad_fn, whose
    backward launches the backward kernel once and gives its plain
    version's gradient; under torch.no_grad() the same call has none."""
    fn, args = _grad_cases(cuda)[case]
    args = [a.detach() for a in args]
    args[which].requires_grad_(True)
    fwd, bwd = flash_attention.LAUNCHES, flash_attention.LAUNCHES_BWD
    out = fn(*args)
    assert out.grad_fn is not None
    do = torch.ones_like(out)
    out.backward(do)
    torch.cuda.synchronize()
    assert (flash_attention.LAUNCHES, flash_attention.LAUNCHES_BWD) == \
        (fwd + 1, bwd + 1)
    q, k, v = (a.detach() for a in args)
    o, lse = flash_attention.flash_attention_plain(q, k, v, return_lse=True)
    want = flash_attention.flash_attention_bwd_plain(q, k, v, o, do, lse)
    got = args[which].grad
    torch.testing.assert_close(got.float(), want[which % 3].float(),
                               atol=flash_bwd_tol(q.dtype, want[which % 3]),
                               rtol=0)
    with torch.no_grad():
        assert fn(*args).grad_fn is None


@pytest.mark.parametrize("case", GRAD_CASES)
@pytest.mark.parametrize("which", [0, -1])
def test_model_kernels_refuse_grad(cuda, case, which):
    """The router wrappers (``router_topk`` on both routes,
    ``topk_gating`` on both paths) no longer refuse a gradient: with grad
    enabled and an input that requires it, the gates carry a grad_fn, one
    backward launches ``topk_gating_bwd`` once, and the gradients equal
    those of the same Function's CPU run (plain forward and backward) to
    f32 rounding (one bf16 ulp of the largest for a bf16 input: cuBLAS and
    the CPU sum the router's transpose in other orders); under
    torch.no_grad() the same call has none."""
    fn, args = _grad_cases(cuda)[case]
    args = [a.detach() for a in args]
    args[which].requires_grad_(True)
    out = fn(*args)
    gates = out[-1]
    assert gates.grad_fn is not None and not out[-2].requires_grad
    dg = torch.from_numpy(np.random.default_rng(7).standard_normal(
        tuple(gates.shape)).astype(np.float32)).to(cuda)
    before = topk_gating.LAUNCHES_BWD
    gates.backward(dg)
    torch.cuda.synchronize()
    assert topk_gating.LAUNCHES_BWD == before + 1
    ref = [a.detach().cpu().requires_grad_(a.requires_grad) for a in args]
    fn(*ref)[-1].backward(dg.cpu())
    got, want = args[which].grad, ref[which].grad
    big = float(want.abs().max())
    tol = 2.0 ** (np.floor(np.log2(big)) - 7) if want.dtype == \
        torch.bfloat16 else 1e-5 * big
    torch.testing.assert_close(got.float().cpu(), want.float(), atol=tol,
                               rtol=0)
    with torch.no_grad():
        outs = fn(*args)
    assert all(o.grad_fn is None for o in outs)


@pytest.mark.parametrize("E,k", [(60, 4), (128, 8), (256, 8), (5, 5)])
@pytest.mark.parametrize("incoming", [False, True])
def test_topk_gating_bwd_kernel(cuda, E, k, incoming):
    """The router backward's kernel against its plain version on the same
    CUDA tensors: the nonzero pattern exact and each value within 1e-6 of
    its row's largest |g dg| (``cardcheck.topk_bwd_err``), bit-identical on
    relaunch, on tied rows and rows with fewer finite logits than k (a
    column chosen again takes every slot's contribution), a strided
    ``dgates`` (autograd's may be), and T = 0."""
    rng = np.random.default_rng(E + k)
    x = _topk_logits(rng, 2049, E)
    x[3::11, 1:] = -np.inf                 # one finite logit
    x[5::11] = -np.inf                     # none
    logits = x.to(cuda)
    idx, gates = topk_gating.topk_gating(logits, k)
    dg = torch.from_numpy(rng.standard_normal((2049, 2 * k)).astype(
        np.float32)).to(cuda)[:, ::2]
    din = torch.from_numpy(rng.standard_normal((2049, E)).astype(
        np.float32)).to(cuda) if incoming else None
    assert any(len(set(r)) < k for r in idx.tolist()) or k == 1
    before = topk_gating.LAUNCHES_BWD
    got = topk_gating.topk_gating_bwd(idx, gates, dg, din, E=E)
    again = topk_gating.topk_gating_bwd(idx, gates, dg, din, E=E)
    torch.cuda.synchronize()
    assert topk_gating.LAUNCHES_BWD == before + 2
    assert same_bits(got, again)
    want = topk_gating.topk_gating_bwd_plain(idx, gates, dg, din, E=E)
    topk_bwd_err(got, want, gates, dg)
    empty = topk_gating.topk_gating_bwd(idx[:0], gates[:0], dg[:0], E=E)
    assert empty.shape == (0, E) and topk_gating.LAUNCHES_BWD == before + 2


# ---------------------------------------------------------------------------
# the rest of the analysis API: one kernel (multirun), the rest on the host
# ---------------------------------------------------------------------------

ANALYSIS_CALLS = [
    ("idle_time", {}), ("comm_by_process", {}),
    ("comm_by_process", {"output": "count"}),
    ("comm_over_time", {"num_bins": 32}), ("comm_comp_breakdown", {}),
    ("logical_steps", {}), ("calculate_lateness", {}),
    ("lateness_by_process", {}), ("critical_path_analysis", {}),
    ("activity_series", {"num_bins": 512}), ("detect_pattern", {}),
    ("detect_pattern", {"start_event": "iteration"}),
]


def test_multirun_on_card_one_seg_sum_per_run(cuda):
    from repro_torch.tracegen import tortuga
    runs = [tortuga(nprocs=n, iters=6, device=cuda) for n in (4, 8, 16, 32)]
    before = _per_kernel()
    card = Trace.multirun_analysis(runs)
    after = _per_kernel()
    assert {k: after[k] - before[k] for k in after} == {
        "seg_sum": 4, "pair_sum": 0, "time_bin": 0, "hist_bin": 0}
    again = Trace.multirun_analysis(runs)         # the profile cache
    assert _per_kernel() == after
    cpu = Trace.multirun_analysis(runs, device="cpu")
    assert list(card.columns) == list(cpu.columns)
    for c in list(card.columns)[1:]:
        gate(np.asarray(card[c]), np.asarray(cpu[c]))
        assert np.array_equal(np.asarray(card[c]), np.asarray(again[c]))


def test_analysis_host_ops_launch_nothing_on_card(cuda):
    ev = big_events(nprocs=8, events_per_proc=8_000, seed=3)
    card = Trace.from_events(ev, device=cuda)
    cpu = Trace.from_events(ev.copy(), device="cpu")
    before = _launches()
    got = [card.run(op, **kw) for op, kw in ANALYSIS_CALLS]
    assert _launches() == before
    for (op, kw), res in zip(ANALYSIS_CALLS, got):
        assert digest(res) == digest(cpu.run(op, **kw)), op


FORMATS = ["csv", "chrome", "otf2j", "otf2j-dir", "hlo"]


@pytest.mark.parametrize("fmt", FORMATS)
def test_each_format_reads_onto_the_card(cuda, fmt, tmp_path):
    """One small file of each format opened with the format sniffed: the
    trace is on the card, every trace kernel launches under the six ops,
    and each result is within the gate of the same file read on the
    CPU."""
    from repro_torch.readers import (write_chrome, write_csv,
                                     write_otf2_json)
    from repro_torch.tracegen import gol
    t = gol(nprocs=4, iters=3, seed=2, device="cpu")
    path = str(tmp_path / {"csv": "t.csv", "chrome": "t.json",
                           "otf2j": "t.otf2.json", "otf2j-dir": "arch",
                           "hlo": "t.hlo"}[fmt])
    if fmt == "hlo":
        from test_readers import HLO_MIN
        with open(path, "w") as f:
            f.write(HLO_MIN)
    else:
        {"csv": write_csv, "chrome": write_chrome,
         "otf2j": write_otf2_json,
         "otf2j-dir": lambda e, p: write_otf2_json(
             e, p, split_locations=True)}[fmt](t, path)
    card = Trace.open(path)
    assert card.device.type == "cuda"
    cpu = Trace.open(path, device="cpu")
    before = _per_kernel()
    for op, kw in (("flat_profile", {}), ("flat_profile",
                                          {"per_process": True}),
                   ("time_profile", {"num_bins": 8}),
                   ("comm_matrix", {}), ("message_histogram", {"bins": 8}),
                   ("stragglers", {"threshold": -1.0})):
        got, want = card.run(op, **kw), cpu.run(op, **kw)
        if op == "message_histogram":
            assert np.array_equal(got[0], want[0])
            assert np.array_equal(got[1], want[1])
        elif op == "stragglers":
            findings_gate(got, want)
        elif op == "comm_matrix":
            gate(got, want)
        else:
            for c in want.columns:
                if np.asarray(want[c]).dtype.kind == "f":
                    gate(np.asarray(got[c]), np.asarray(want[c]))
    after = _per_kernel()
    assert all(after[k] > before[k] for k in after), (before, after)


@pytest.mark.parametrize("arch", ["gemma3-27b", "hymba-1.5b",
                                  "mamba2-130m"])
def test_family_smoke_serves_the_cpu_tokens_on_the_card(cuda, arch):
    """Slice 15's families at smoke size in f32, one weight set served on
    the card and on the CPU through the same engine: the same greedy
    tokens, prefill logits within 1e-3; flash launched on the card for
    the two attention families only."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    cfg = get_smoke_config(arch)
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0)).state_dict()
    out = {}
    for dev in ("cuda", "cpu"):
        logits = []
        eng = ServeEngine(cfg, batch=4, cache_len=128, params=params,
                          device=dev)
        eng.logits_hook = (lambda ph, lg, _l=logits:
                           _l.append(lg.float().cpu()) if ph == "prefill"
                           else None)
        before = flash_attention.LAUNCHES
        done = eng.serve_queue(make_requests(cfg.vocab, 8, 32, 8))
        launched = flash_attention.LAUNCHES - before
        assert (launched > 0) == (dev == "cuda" and cfg.family != "ssm")
        out[dev] = ([r.out_tokens for r in done], torch.cat(logits))
    assert out["cuda"][0] == out["cpu"][0]
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], atol=1e-3,
                               rtol=0)


SHARDED_1X1 = """
import dataclasses, json, os, sys, tempfile
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
store = os.path.join(tempfile.mkdtemp(), "store")
dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0,
                        world_size=1)
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import router_topk as rt
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.serve import make_requests
from repro_torch.launch.steps import CellEngine, build_cell, place
from repro_torch.models import build_model
from repro_torch.models.config import ShapeConfig
from repro_torch.serving import ServeEngine
from torch.distributed.tensor import Replicate
mesh = make_local_mesh()
refused = []
x = place(torch.randn(8, 64, device="cuda").bfloat16(), mesh,
          [Replicate(), Replicate()])
w = place(torch.randn(64, 16, device="cuda").bfloat16(), mesh,
          [Replicate(), Replicate()])
for call in (lambda: rt.router_topk(x, w, 2),
             lambda: fa.flash_attention(*(place(
                 torch.randn(1, 8, 2, 64, device="cuda"), mesh,
                 [Replicate(), Replicate()]) for _ in range(3)))):
    try:
        call()
    except TypeError as e:
        refused.append("DTensor" in str(e))
cfg = get_smoke_config(sys.argv[1])
if cfg.hd < 16:         # qwen1.5-110b-smoke: 8-wide heads, below the kernel's
    cfg = dataclasses.replace(cfg, head_dim=16)
params = build_model(cfg, device="cpu").init(
    torch.Generator().manual_seed(0)).state_dict()
reqs = make_requests(cfg.vocab, 4, 24, 6)
eng = ServeEngine(cfg, batch=4, cache_len=64, params=params, device="cuda")
before = fa.LAUNCHES
want = [r.out_tokens for r in eng.generate(reqs)]
plain = fa.LAUNCHES - before
model = build_model(cfg, device="cuda")
model.load_state_dict(params)
pre = build_cell(cfg, ShapeConfig("p", 64, 4, "prefill"), mesh,
                 model=model)
dec = build_cell(cfg, ShapeConfig("d", 64, 4, "decode"), mesh, model=model)
assert isinstance(model.embed, DTensor)
before = fa.LAUNCHES
got = [r.out_tokens for r in CellEngine(pre, dec, batch=4).generate(
    make_requests(cfg.vocab, 4, 24, 6))]
print("RESULT " + json.dumps({"refused": refused, "want": want, "got": got,
                              "plain": plain,
                              "sharded": fa.LAUNCHES - before}))
dist.destroy_process_group()
"""


@pytest.mark.parametrize("arch", ["qwen1.5-110b", "qwen3-moe-235b-a22b"])
def test_sharded_1x1_serve_equals_the_unsharded_serve(cuda, arch):
    """On a (1, 1) NCCL mesh (world size 1, in a subprocess) the smoke
    config's prefill and decode cells (``launch.steps.CellEngine``) give the
    engine's greedy tokens with the same flash launches; the model-kernel
    wrappers refuse a DTensor.  qwen1.5-110b-smoke's heads (8 wide) are
    widened to 16, the flash kernel's smallest head dim."""
    import json
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    r = subprocess.run([sys.executable, "-c", SHARDED_1X1, arch],
                       capture_output=True, text=True, cwd=root, env=env,
                       timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    out = json.loads([x for x in r.stdout.splitlines()
                      if x.startswith("RESULT ")][-1][len("RESULT "):])
    assert out["refused"] == [True, True]
    assert out["got"] == out["want"]
    assert out["sharded"] == out["plain"] > 0
