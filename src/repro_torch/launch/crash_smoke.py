"""Crash-consistency smoke: SIGKILL a pack writer mid-write, repair,
serve, and require the served digest to match a direct library read.

Mirrors the reference's ``tools/crash_smoke.py`` on the port.  Closed
loop, every gate hard:

1. a ``tracegen.big_trace`` pack write runs in a subprocess and is
   SIGKILLed once the destination holds real chunk groups;
2. ``python -m repro_torch.launch.pack --repair`` must salvage the torn
   pack (non-empty, verify-clean output);
3. the recovered rows must be a bit-exact prefix of the same generator's
   full output (nothing invented, nothing reordered);
4. a trace-query service (``repro_torch.launch.trace_serve``) over the
   repaired pack must return the ``flat_profile`` digest of a direct
   ``Trace.open`` on the same device.

It also runs a **live-ingest smoke** (``--skip-live`` to omit): an 8-rank
live writer fleet (``Tracer`` with append-mode sinks and heartbeats) is
polled twice through :class:`~repro_torch.core.liveset.LiveTraceSet`
(per-rank watermarks never go back), two ranks are SIGKILLed mid-commit,
and after ``dead_timeout`` the degraded query must cover exactly the six
survivors (the dead ranks named in the coverage report), with the eager,
streamed and parallel digests equal over the committed prefix.

``--matrix-json`` writes a **fault matrix**: every text and pack reader x
{truncate 25/75/99 %, bit flip, garbage tail} x {strict, lenient}, with
the observed outcome.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.crash_smoke [--events N]
        [--matrix-json fault_matrix.json] [--skip-live] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

WRITER = """
import sys
sys.path.insert(0, {src!r})
from repro_torch.tracegen.big import big_trace
print("ready", flush=True)
big_trace({out!r}, nprocs=1, events_per_proc={events}, format="pack")
print("done", flush=True)
"""


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=SRC + os.pathsep
                + os.environ.get("PYTHONPATH", ""))


def start_server(device: str):
    """The trace-query service in a subprocess on ``device``:
    (Popen, port)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.trace_serve",
         "--port", "0", "--announce", "--device", device],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env())
    line = proc.stdout.readline()
    if not line.startswith("SERVING "):
        rest = proc.stdout.read()
        proc.kill()
        proc.wait()
        raise RuntimeError(f"server failed to start: {line!r} {rest[:2000]}")
    return proc, json.loads(line.split(None, 1)[1])["port"]


def crash_consistency(events: int, device: str) -> dict:
    import numpy as np

    from ..core.constants import TS
    from ..core.trace import Trace
    from ..readers.pack import verify_pack
    from ..serving.client import ServiceClient
    from ..serving.protocol import result_digest
    from ..tracegen.big import big_trace

    out = {}
    with tempfile.TemporaryDirectory(prefix="crash_smoke_") as tmp:
        shard_dir = os.path.join(tmp, "torn")
        victim = os.path.join(shard_dir, "rank_0.pack")
        proc = subprocess.Popen(
            [sys.executable, "-c",
             WRITER.format(src=SRC, out=shard_dir, events=events)],
            stdout=subprocess.PIPE, text=True)
        try:
            if proc.stdout.readline().strip() != "ready":
                raise RuntimeError("writer did not start")
            # wait for at least one finished chunk group (250k rows x ~33
            # bytes a row ~= 8 MB), then kill mid-write of a later one
            deadline = time.time() + 120
            while time.time() < deadline:
                if (os.path.exists(victim)
                        and os.path.getsize(victim) > 9_000_000):
                    break
                time.sleep(0.002)
            else:
                raise RuntimeError("writer never produced bytes to tear")
        finally:
            proc.send_signal(signal.SIGKILL)
            proc.wait()
        out["torn_bytes"] = os.path.getsize(victim)

        repaired = os.path.join(tmp, "repaired.pack")
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.pack", "--repair",
             victim, "-o", repaired],
            capture_output=True, text=True, env=_env())
        out["repair_rc"] = r.returncode
        out["repair_log"] = r.stdout.strip()
        if r.returncode != 0:
            raise SystemExit(f"repair failed:\n{r.stdout}{r.stderr}")

        rep = verify_pack(repaired)
        out["repaired_rows"] = rep["rows"]
        if not (rep["ok"] and rep["rows"] > 0):
            raise SystemExit(f"repaired pack not verify-clean: {rep}")

        # the recovered rows are a bit-exact prefix of the full generation
        full_dir = os.path.join(tmp, "full")
        big_trace(full_dir, nprocs=1, events_per_proc=events, format="pack")
        got = np.asarray(Trace.open(repaired, device=device).events[TS],
                         np.int64)
        want = np.asarray(
            Trace.open(os.path.join(full_dir, "rank_0.pack"),
                       device=device).events[TS], np.int64)[:len(got)]
        if not np.array_equal(got, want):
            raise SystemExit("recovered rows are not a prefix of the "
                             "generator's output")
        out["prefix_exact"] = True

        # served digest == library digest over the repaired pack
        lib_digest = result_digest(
            Trace.open(repaired, device=device).query().run(
                "flat_profile", cache=False))
        srv, port = start_server(device)
        try:
            c = ServiceClient("127.0.0.1", port, tenant="smoke")
            served = c.open(repaired).query().run("flat_profile",
                                                  cache=False)
            out["served_digest_equal"] = \
                result_digest(served) == lib_digest
            c.close()
        finally:
            srv.kill()
            srv.wait(timeout=30)
        if not out["served_digest_equal"]:
            raise SystemExit("served digest != library digest")
    return out


LIVE_WRITER = """
import sys, time
sys.path.insert(0, {src!r})
from repro_torch.runtime.tracer import Tracer
tr = Tracer(process={rank}, sink={sink!r}, flush_every=2000,
            heartbeat_interval=0.2, fsync=False)
print("ready", flush=True)
i = 0
while True:
    with tr.span("fn%d" % (i % 11), proc={rank}):
        tr.instant("tick", proc={rank})
    i += 1
    if i % 2000 == 0:
        time.sleep(0.01)   # pace the loop so the fleet outlives the polls
"""

NRANKS = 8
KILL_RANKS = (2, 5)


def live_ingest(device: str) -> dict:
    """8-rank live fleet: watermarks never go back while it grows; two
    ranks SIGKILLed; survivor-only degraded queries whose eager, streamed
    and parallel digests agree."""
    from ..core.liveset import LiveTraceSet
    from ..core.streaming import LiveTrace
    from ..readers.pack import committed_prefix
    from ..serving.protocol import result_digest

    out = {}
    with tempfile.TemporaryDirectory(prefix="live_smoke_") as tmp:
        sinks = [os.path.join(tmp, f"rank_{r}.pack")
                 for r in range(NRANKS)]
        procs = [subprocess.Popen(
            [sys.executable, "-c",
             LIVE_WRITER.format(src=SRC, rank=r, sink=sinks[r])],
            stdout=subprocess.PIPE, text=True) for r in range(NRANKS)]
        try:
            for p in procs:
                if p.stdout.readline().strip() != "ready":
                    raise RuntimeError("a fleet rank did not start")
            deadline = time.time() + 120
            while time.time() < deadline:
                if all(os.path.exists(s) and committed_prefix(s)["rows"] > 0
                       for s in sinks):
                    break
                time.sleep(0.01)
            else:
                raise RuntimeError("fleet never committed rows")

            ls = LiveTraceSet(tmp, lag_timeout=1.5, dead_timeout=4.0,
                              device=device)
            cov = ls.coverage
            if cov.included != list(range(NRANKS)):
                raise SystemExit(f"fleet not fully live: {cov.as_dict()}")
            wm1 = {r: cov.per_rank[r]["rows"] for r in cov.included}

            time.sleep(0.6)
            cov = ls.refresh()
            wm2 = {r: cov.per_rank[r]["rows"] for r in cov.included}
            if any(wm2[r] < wm1[r] for r in wm1):
                raise SystemExit(f"watermark went backwards: {wm1} {wm2}")
            if sum(wm2.values()) <= sum(wm1.values()):
                raise SystemExit("fleet-wide watermark did not advance "
                                 f"between polls: {wm1} {wm2}")
            out["watermarks_monotone"] = True
            out["rows_poll1"] = sum(wm1.values())
            out["rows_poll2"] = sum(wm2.values())

            for r in KILL_RANKS:
                procs[r].send_signal(signal.SIGKILL)
                procs[r].wait()
            time.sleep(4.5)   # past dead_timeout; survivors keep writing

            cov = ls.refresh()
            survivors = [r for r in range(NRANKS) if r not in KILL_RANKS]
            if cov.included != survivors or cov.missing != list(KILL_RANKS):
                raise SystemExit(
                    f"wrong degraded coverage: {cov.as_dict()}")
            out["missing_ranks"] = cov.missing
            out["survivor_rows"] = ls.watermark.rows
            out["staleness_spread"] = cov.staleness_spread
            # the dead ranks' committed prefixes are still reported
            if any(cov.per_rank[r]["rows"] <= 0 for r in KILL_RANKS):
                raise SystemExit("dead ranks lost their committed prefix")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()

        # the fleet has stopped: the committed prefixes are frozen, so the
        # eager, streamed and parallel digests must agree
        spaths = [sinks[r] for r in range(NRANKS) if r not in KILL_RANKS]
        serial = LiveTrace(spaths, cache=False, device=device)
        d_stream = result_digest(
            serial.query().run("flat_profile", cache=False))
        d_eager = result_digest(
            serial.materialize().query().run("flat_profile", cache=False))
        d_par = result_digest(
            LiveTrace(spaths, processes=2, executor="parallel",
                      cache=False, device=device).query().run(
                          "flat_profile", cache=False))
        out["digests_agree"] = (d_stream == d_eager == d_par)
        if not out["digests_agree"]:
            raise SystemExit(
                f"digest disagreement on committed prefix: "
                f"stream={d_stream} eager={d_eager} par={d_par}")
    return out


def fault_matrix(device: str = "cuda") -> list:
    """Outcome census: reader x corruption x policy on small goldens."""
    from .. import tracegen
    from ..core.errors import TraceReadError
    from ..core.trace import Trace
    from ..readers.chrome import write_chrome
    from ..readers.csvreader import write_csv
    from ..readers.jsonl import write_jsonl
    from ..readers.otf2j import write_otf2_json
    from ..readers.pack import write_pack
    from ..testing.faults import bit_flip, garbage_append, truncate_at

    golden = tracegen.gol(nprocs=3, iters=4, seed=7, device=device)
    writers = {"jsonl": ("g.jsonl", write_jsonl),
               "csv": ("g.csv", write_csv),
               "chrome": ("g.json", write_chrome),
               "otf2j": ("g.otf2.json", write_otf2_json),
               "pack": ("g.pack",
                        lambda t, p: write_pack(t, p, chunk_rows=20))}
    hurts = {"trunc25": lambda s, d: truncate_at(s, d, frac=0.25),
             "trunc75": lambda s, d: truncate_at(s, d, frac=0.75),
             "trunc99": lambda s, d: truncate_at(s, d, frac=0.99),
             "bitflip": lambda s, d: bit_flip(s, d, frac=0.5, count=4,
                                              seed=13),
             "garbage": lambda s, d: garbage_append(s, d, nbytes=97,
                                                    seed=13)}
    rows = []
    with tempfile.TemporaryDirectory(prefix="fault_matrix_") as tmp:
        for fmt, (name, writer) in writers.items():
            src = os.path.join(tmp, name)
            writer(golden, src)
            lenient = "salvage" if fmt == "pack" else "skip"
            for hurt, injure in hurts.items():
                dst = os.path.join(tmp, f"{hurt}-{name}")
                injure(src, dst)
                for policy in ("strict", lenient):
                    row = {"format": fmt, "corruption": hurt,
                           "policy": policy}
                    try:
                        t = Trace.open(dst, format=fmt, on_error=policy,
                                       device=device)
                        rpt = t.ingest_report()
                        row.update(outcome="opened",
                                   rows=len(t.events),
                                   clean=rpt.clean,
                                   skipped=rpt.total_skipped())
                    except (TraceReadError, ValueError) as e:
                        row.update(outcome="raised",
                                   error=str(e)[:200],
                                   names_file=os.path.basename(dst)
                                   in str(e))
                    rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--events", type=int, default=2_000_000,
                    help="events in the torn shard's generator")
    ap.add_argument("--matrix-json",
                    help="write the reader x corruption x policy outcome "
                    "matrix to PATH")
    ap.add_argument("--skip-live", action="store_true",
                    help="skip the live-ingest rank-failure smoke")
    ap.add_argument("--device", default="cuda",
                    help='where the ops run: "cuda" (default) or "cpu"')
    args = ap.parse_args(argv)

    result = {"crash_consistency": crash_consistency(args.events,
                                                     args.device)}
    if not args.skip_live:
        result["live_ingest"] = live_ingest(args.device)
    print(json.dumps(result, indent=2))

    if args.matrix_json:
        rows = fault_matrix(args.device)
        with open(args.matrix_json, "w") as f:
            json.dump(rows, f, indent=1)
        raised_unnamed = [r for r in rows if r["outcome"] == "raised"
                          and not r["names_file"]]
        print(f"fault matrix: {len(rows)} cells -> {args.matrix_json}")
        if raised_unnamed:
            print("FAIL: errors not naming the damaged file:",
                  json.dumps(raised_unnamed, indent=1))
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
