"""The port's fault-injection harness and robustness tools:
``tests/test_faults.py`` on ``repro_torch``.

* ``repro_torch.testing.faults``' file injectors are deterministic and
  damage the same bytes as the reference's on the same seed;
* ``python -m repro_torch.launch.pack --verify`` / ``--repair`` /
  ``--watermark`` and the conversion with its digest check
  (``--device cpu``) work as the reference's tool;
* a pack writer SIGKILLed mid-write is repaired to a verify-clean prefix,
  and ``python -m repro_torch.launch.crash_smoke``'s fault matrix names
  the damaged file in every error;
* the service client retries through ``FaultProxy`` resets, before and
  after part of a response, and the handle pool's breaker trips and
  recovers under ``flaky_opens``, its fast-fail naming the pack tool.
"""

import asyncio
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from repro.testing import faults as ref_faults
from repro_torch import Trace
from repro_torch.core import plancache
from repro_torch.core.constants import TS
from repro_torch.launch.cardcheck import digest
from repro_torch.readers.pack import read_pack, verify_pack, write_pack
from repro_torch.serving.client import ServiceClient
from repro_torch.serving.protocol import result_digest
from repro_torch.serving.tracequery import (ServiceError, TraceServer,
                                            TraceService)
from repro_torch.testing import faults
from repro_torch.testing.faults import (FaultProxy, bit_flip, flaky_opens,
                                        garbage_append, torn_footer,
                                        truncate_at)
from repro_torch.tracegen import gol

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


def run(coro):
    return asyncio.run(coro)


def _env():
    return dict(os.environ, PYTHONPATH=SRC)


def _tool(*argv):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.pack", *argv],
        capture_output=True, text=True, env=_env(), timeout=300)


@pytest.fixture(scope="module")
def golden_pack(tmp_path_factory):
    """A pack in many small chunk groups, so that damage to one group has
    a known blast radius."""
    p = str(tmp_path_factory.mktemp("faults") / "golden.pack")
    write_pack(gol(nprocs=3, iters=10, seed=5, device="cpu"), p,
               chunk_rows=40)
    return p


@pytest.fixture()
def fresh_cache():
    plancache.clear()
    yield
    plancache.clear()


def service(**kw):
    return TraceService(device="cpu", **kw)


def _bytes(p):
    with open(p, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# the file injectors: deterministic, the reference's bytes
# ---------------------------------------------------------------------------

INJECTIONS = {
    "bit_flip": lambda m, s, d: m.bit_flip(s, d, frac=0.4, count=3, seed=9),
    "bit_flip_offsets": lambda m, s, d: m.bit_flip(s, d, offsets=[5, 977],
                                                   seed=2),
    "garbage_append": lambda m, s, d: m.garbage_append(s, d, nbytes=64,
                                                       seed=9),
    "truncate_frac": lambda m, s, d: m.truncate_at(s, d, frac=0.25),
    "truncate_offset": lambda m, s, d: m.truncate_at(s, d, offset=1000),
    "torn_footer": lambda m, s, d: m.torn_footer(s, d, keep_frac=0.3),
}


@pytest.mark.parametrize("kind", sorted(INJECTIONS))
def test_injectors_damage_the_reference_bytes(kind, golden_pack, tmp_path):
    a, b, r = (str(tmp_path / n) for n in ("a.pack", "b.pack", "r.pack"))
    ra = INJECTIONS[kind](faults, golden_pack, a)
    rb = INJECTIONS[kind](faults, golden_pack, b)
    rr = INJECTIONS[kind](ref_faults, golden_pack, r)
    assert ra == rb == rr
    assert _bytes(a) == _bytes(b) == _bytes(r)
    assert _bytes(golden_pack) != _bytes(a)


def test_truncate_reports_the_cut(golden_pack, tmp_path):
    a = str(tmp_path / "a.pack")
    r = truncate_at(golden_pack, a, frac=0.25)
    assert r["cut_at"] == os.path.getsize(a)
    assert r["lost"] == r["size"] - r["cut_at"]
    with pytest.raises(ValueError, match="offset= or frac="):
        truncate_at(golden_pack, a)


def test_torn_footer_rebuilds_every_row(golden_pack, tmp_path):
    full = read_pack(golden_pack, device="cpu")
    torn = str(tmp_path / "torn.pack")
    torn_footer(golden_pack, torn)
    with pytest.raises(ValueError, match="torn.pack"):
        read_pack(torn, on_error="strict", device="cpu")
    t = read_pack(torn, on_error="salvage", device="cpu")
    np.testing.assert_array_equal(np.asarray(t.events[TS]),
                                  np.asarray(full.events[TS]))


def test_single_group_flip_quarantines_that_group(golden_pack, tmp_path):
    full = read_pack(golden_pack, device="cpu")
    bad = str(tmp_path / "flip.pack")
    bit_flip(golden_pack, bad, frac=0.4, count=1, seed=3)
    rep = verify_pack(bad)
    assert not rep["ok"] and rep["chunks_bad"]
    t = read_pack(bad, on_error="salvage", device="cpu")
    lost = sum(g["rows"][1] - g["rows"][0] for g in rep["chunks_bad"])
    assert len(t) == len(full) - lost


def test_garbage_tail_salvages_every_row(golden_pack, tmp_path):
    gar = str(tmp_path / "gar.pack")
    garbage_append(golden_pack, gar, nbytes=512, seed=1)
    with pytest.raises(ValueError, match="gar.pack"):
        read_pack(gar, on_error="strict", device="cpu")
    assert len(read_pack(gar, on_error="salvage", device="cpu")) == \
        len(read_pack(golden_pack, device="cpu"))


# ---------------------------------------------------------------------------
# python -m repro_torch.launch.pack
# ---------------------------------------------------------------------------

def test_cli_verify_and_repair(golden_pack, tmp_path):
    r = _tool("--verify", golden_pack)
    assert r.returncode == 0 and "OK" in r.stdout, r.stdout + r.stderr

    bad = str(tmp_path / "cli.pack")
    torn_footer(golden_pack, bad)
    r = _tool("--verify", bad)
    assert r.returncode == 1
    assert "repair" in r.stdout.lower()

    fixed = str(tmp_path / "fixed.pack")
    r = _tool("--repair", bad, "-o", fixed)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "footer rebuilt" in r.stdout
    assert _tool("--verify", fixed).returncode == 0
    np.testing.assert_array_equal(
        np.asarray(read_pack(fixed, device="cpu").events[TS]),
        np.asarray(read_pack(golden_pack, device="cpu").events[TS]))


def test_cli_converts_every_format_and_checks_the_digest(tmp_path):
    """Conversion of csv, chrome and an otf2j directory with ``--verify``
    (the digest's ``flat_profile`` on the CPU); the pack reopens with the
    source's bits."""
    from repro_torch.readers import write_chrome, write_csv, write_otf2_json
    t = gol(nprocs=3, iters=4, seed=7, device="cpu")
    srcs = [str(tmp_path / "a.csv"), str(tmp_path / "b.json"),
            str(tmp_path / "arch")]
    write_csv(t, srcs[0])
    write_chrome(t, srcs[1])
    write_otf2_json(t, srcs[2], split_locations=True)
    out = str(tmp_path / "packs")
    r = _tool(*srcs, "-o", out, "--verify", "--device", "cpu")
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("verify: OK") == 3
    packs = sorted(os.listdir(out))
    assert packs == ["a.pack", "arch.pack", "b.pack"]
    got = Trace.open(os.path.join(out, "arch.pack"), device="cpu")
    assert digest(got.flat_profile()) == digest(
        Trace.open(srcs[2], device="cpu").flat_profile())


def test_cli_watermark_reports_the_committed_prefix(golden_pack):
    r = _tool("--watermark", golden_pack)
    assert r.returncode == 0, r.stderr
    wm = json.loads(r.stdout.splitlines()[0])
    assert wm["path"] == golden_pack
    assert wm["rows"] == len(read_pack(golden_pack, device="cpu"))


def test_cli_refuses_a_card_it_does_not_have(golden_pack, tmp_path):
    """Conversion asks for the card by default; without one it fails
    rather than running on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")
    src = str(tmp_path / "g.csv")
    from repro_torch.readers import write_csv
    write_csv(gol(nprocs=2, iters=2, seed=1, device="cpu"), src)
    r = _tool(src, "--verify")
    assert r.returncode != 0 and "CUDA" in r.stderr


def test_crash_consistency_sigkill_mid_write(tmp_path):
    """SIGKILL a writer partway through a pack write: the strict open
    fails, ``--repair`` recovers a verify-clean prefix of the source."""
    dst = str(tmp_path / "crash.pack")
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from repro_torch.tracegen import gol\n"
        "from repro_torch.readers.pack import write_pack\n"
        "t = gol(nprocs=3, iters=200, seed=2, device='cpu')\n"
        "print('ready', len(t.events), flush=True)\n"
        "write_pack(t, %r, chunk_rows=16)\n"
        "print('done', flush=True)\n" % (SRC, dst))
    proc = subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, text=True)
    assert proc.stdout.readline().startswith("ready")
    deadline = time.time() + 60
    while time.time() < deadline:
        if os.path.exists(dst) and os.path.getsize(dst) > 4096:
            break
        time.sleep(0.0005)
    proc.send_signal(signal.SIGKILL)
    proc.wait()
    assert os.path.getsize(dst) > 0
    fixed = str(tmp_path / "recovered.pack")
    r = _tool("--repair", dst, "-o", fixed)
    assert r.returncode == 0, r.stdout + r.stderr
    assert _tool("--verify", fixed).returncode == 0
    ts = np.asarray(read_pack(fixed, device="cpu").events[TS])
    src_ts = np.asarray(gol(nprocs=3, iters=200, seed=2,
                            device="cpu").events[TS], np.int64)
    assert 0 < len(ts) <= len(src_ts)
    np.testing.assert_array_equal(ts, src_ts[:len(ts)])


def test_crash_smoke_fault_matrix_names_the_file():
    from repro_torch.launch.crash_smoke import fault_matrix
    rows = fault_matrix(device="cpu")
    assert len(rows) == 5 * 5 * 2
    raised = [r for r in rows if r["outcome"] == "raised"]
    assert raised and all(r["names_file"] for r in raised)
    lenient = [r for r in rows if r["policy"] in ("skip", "salvage")]
    assert all(r["outcome"] == "opened" or r["names_file"]
               for r in lenient)


# ---------------------------------------------------------------------------
# transport faults and the breaker
# ---------------------------------------------------------------------------

def _through_proxy(golden_pack, n, **proxy_kw):
    async def main():
        server = await TraceServer(service(), port=0).start()

        def client_work():
            with FaultProxy("127.0.0.1", server.port, **proxy_kw) as proxy:
                with ServiceClient("127.0.0.1", proxy.port, retries=4,
                                   backoff=0.01) as c:
                    profs = [c.open(golden_pack).query().flat_profile()
                             for _ in range(n)]
                    return profs, c.retry_count, dict(proxy.stats)

        out = await asyncio.to_thread(client_work)
        await server.shutdown(grace=5)
        return out

    return run(main())


def test_client_retries_through_connection_resets(golden_pack,
                                                  fresh_cache):
    local = Trace.open(golden_pack, device="cpu").query().flat_profile()
    profs, retries, stats = _through_proxy(golden_pack, 6, reset_every=2)
    assert len(profs) == 6
    assert all(result_digest(p) == result_digest(local) for p in profs)
    assert retries >= 1 and stats["resets"] >= 1


def test_client_survives_mid_response_reset(golden_pack, fresh_cache):
    local = Trace.open(golden_pack, device="cpu").query().flat_profile()
    profs, _retries, stats = _through_proxy(golden_pack, 4, reset_every=2,
                                            reset_after_bytes=40)
    assert len(profs) == 4
    assert all(result_digest(p) == result_digest(local) for p in profs)
    assert stats["resets"] >= 1


def test_breaker_trips_and_recovers(golden_pack, fresh_cache):
    async def main():
        svc = service(breaker_threshold=3, breaker_cooldown=0.2)

        def body():
            return {"open": {"paths": [golden_pack], "streaming": False},
                    "op": "flat_profile", "steps": [], "tenant": "t",
                    "args": [], "kwargs": {}, "cache": False}

        codes = []
        with flaky_opens(3) as counter:
            for _ in range(5):
                try:
                    await svc.query(body())
                    codes.append("ok")
                except ServiceError as e:
                    codes.append((e.status, e.code))
        await asyncio.sleep(0.25)
        out = await svc.query(body())
        return codes, counter, svc.handles.stats(), out

    codes, counter, stats, out = run(main())
    assert codes[:2] == [(404, "open_failed")] * 2
    assert codes[2:] == [(422, "source_corrupt")] * 3
    assert counter["failed"] == 3 and counter["calls"] == 3
    assert stats["breaker_trips"] >= 1 and stats["breaker_fastfails"] >= 2
    assert out["ok"]


def test_breaker_fastfail_names_the_pack_tool(tmp_path, fresh_cache):
    bad = str(tmp_path / "bad.pack")
    with open(bad, "wb") as f:
        f.write(b"#pipitpack 2\n" + b"\x00" * 64)

    async def main():
        svc = service(breaker_threshold=2, breaker_cooldown=60.0)
        body = {"open": {"paths": [bad], "streaming": False},
                "op": "flat_profile", "steps": [], "tenant": "t",
                "args": [], "kwargs": {}, "cache": False}
        last = None
        for _ in range(3):
            try:
                await svc.query(body)
            except ServiceError as e:
                last = e
        return last

    err = run(main())
    assert err.status == 422 and err.code == "source_corrupt"
    msg = str(err)
    assert f"python -m repro_torch.launch.pack --verify {bad}" in msg
    assert "--repair" in msg and "salvage" in msg
