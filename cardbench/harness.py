"""The harness: one cell, one seed, one run.

It reads the cell (``workloads/<name>.json``), its configuration and its
mix, refuses to run without the CUDA devices the cell asks for, hands
the run to the module of the cell's ``kind`` (``kinds/<kind>.py``), and
prints the result.  That module sets up, measures for ``seconds``, and
judges what the timed path produced against the plain reference; the
harness turns that into the result's line: the cell's end-to-end metrics
(``--trace 0``) or its per-layer metrics, each read by its own reader in
``metrics/<name>.py`` (``--trace 1``), as ``BENCHMARK.json`` lists them.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import re
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
#: top-level modules that may not be loaded in a run's process: JAX and
#: the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    cell: dict
    config: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float                   # the process's start on the host clock


@dataclasses.dataclass
class Outcome:
    """What a kind's module hands back."""
    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, float]            # number compared -> its reading
    memory_peak_bytes: int
    table: Any = None                   # devtrace.Table of a traced run
    layer: Dict[str, Any] = dataclasses.field(default_factory=dict)
    notes: List[str] = dataclasses.field(default_factory=list)


def _json(kind: str, name: str) -> dict:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    return json.loads((HERE / kind / f"{name}.json").read_text())


def load_cell(name: str) -> Run:
    cell = _json("workloads", name)
    return Run(cell, _json("configs", cell["config"]),
               _json("traffic", cell["traffic"]), 0, 0.0, False, "cuda",
               time.perf_counter())


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def metrics_of(cell: str, section: str, bench: dict) -> List[dict]:
    """The ``section`` metrics that ``cell`` reports: those that list it,
    and those without a list that move (or are) a metric it reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if section == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read``."""
    if not NAME.match(metric):
        raise ValueError(f"bad metric name {metric!r}")
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"cardbench.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def judge(readings: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, dict]]:
    """Each number that ``limits`` names, at or under its limit (a NaN
    fails)."""
    out = {k: {"value": readings[k], "limit": lim}
           for k, lim in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in out.values())
    return ok, out


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def execute(run: Run, bench: Optional[dict] = None) -> dict:
    """Drive one run of ``run.cell`` and build the result's line."""
    kind = importlib.import_module(f"cardbench.kinds.{run.cell['kind']}")
    out: Outcome = kind.run(run)
    ok, checks = judge(out.checks, run.cell["checks"])
    correct = ok and out.failed == 0
    bench = bench or benchmark()
    name = run.cell["name"]
    metrics = {}
    if run.trace:
        for m in metrics_of(name, "per_layer", bench):
            v = reader(m["name"])(out.table, out.layer)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in metrics_of(name, "end_to_end", bench):
            metrics[m["name"]] = {"value": out.end_to_end[m["name"]],
                                  "unit": m["unit"]}
    device = {"platform": "gpu" if run.device == "cuda" else run.device,
              "kind": _device_name(run.device),
              "count": int(run.cell["chips"]),
              "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": bool(correct), "attempted": int(out.attempted),
              "failed": int(out.failed), "metrics": metrics,
              "device": device}
    if run.trace and out.table is not None:
        from . import devtrace
        device["busy_s"] = out.table.busy_s()
        device["window_s"] = out.table.wall_s
        result["breakdown"] = devtrace.breakdown(out.table)
    result["checks"] = checks
    result["_notes"] = out.notes
    return result


def _device_name(device: str) -> str:
    import torch
    if device == "cuda":
        return torch.cuda.get_device_name(0)
    return device


def _cards(torch) -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def main(argv: List[str], t0: float) -> int:
    ap = argparse.ArgumentParser(prog="cardbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    run = load_cell(args.workload)
    run.seed, run.seconds, run.trace, run.t0 = (
        args.seed, args.seconds, bool(args.trace), t0)
    import torch
    want = int(run.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < want:
        print(f"cardbench: {args.workload} needs {want} CUDA device(s); "
              f"this machine has {_cards(torch)}", file=sys.stderr)
        return 2
    result = execute(run)
    bad = forbidden_modules()
    if bad:
        print(f"cardbench: the run loaded {bad}, which the port may not "
              f"import", file=sys.stderr)
        return 3
    for note in result.pop("_notes"):
        print(note, file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0
