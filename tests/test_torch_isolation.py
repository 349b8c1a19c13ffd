"""The port stands alone: it imports neither ``jax`` nor anything of the
reference package ``repro``, and its entry points run on the card unless
the caller asks for the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import Trace
from repro_torch.core import accel, detectors, ops_comm, ops_summary
from repro_torch.tracegen import big_events

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "repro")


def _imported_roots(path):
    roots = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots += [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.append(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    bad = [r for r in _imported_roots(path) if r in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


NEW_MODULES = ("repro_torch.parallel_util", "repro_torch.core.executor",
               "repro_torch.readers.parallel", "repro_torch.readers.pack",
               "repro_torch.core.plancache", "repro_torch.core.cancellation",
               "repro_torch.core.scheduler", "repro_torch.core.liveset",
               "repro_torch.runtime.tracer", "repro_torch.serving.protocol",
               "repro_torch.serving.tracequery", "repro_torch.serving.client",
               "repro_torch.launch.trace_serve", "repro_torch.core.diff",
               "repro_torch.tracegen.builder",
               "repro_torch.tracegen.pathologies",
               "repro_torch.core.intervals", "repro_torch.core.ops_logical",
               "repro_torch.core.ops_patterns", "repro_torch.core.viz",
               "repro_torch.tracegen.apps")


def test_new_modules_are_checked():
    """The parallel, pack, live, service, set, pathology and analysis-API
    modules are among the files checked above."""
    checked = {str(p.relative_to(ROOT / "src"))[:-3].replace(os.sep, ".")
               for p in PORT_FILES if "src" in p.parts}
    assert set(NEW_MODULES) <= checked


def test_import_leaves_jax_and_repro_unloaded():
    code = ("import sys, repro_torch, repro_torch.readers, "
            "repro_torch.tracegen, repro_torch.convert, "
            + ", ".join(NEW_MODULES) + "; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_import_leaves_matplotlib_unloaded():
    """The plots import matplotlib when they draw, so importing the port
    (``core.viz`` among its modules) loads none of it."""
    code = ("import sys, repro_torch, repro_torch.tracegen, "
            + ", ".join(NEW_MODULES) + "; "
            "bad = [m for m in sys.modules if m.split('.')[0] == "
            "'matplotlib']; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")


@pytest.fixture(scope="module")
def cpu_trace():
    t = Trace.from_events(big_events(nprocs=2, events_per_proc=300,
                                     calls_per_iter=10), device="cpu")
    t._ensure_structure()
    t._ensure_messages()
    return t


def test_trace_defaults_to_the_card_and_raises_without_one(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        Trace.from_events(big_events(nprocs=2, events_per_proc=300,
                                     calls_per_iter=10))


@pytest.mark.parametrize("op", [ops_summary.flat_profile,
                                ops_summary.time_profile,
                                ops_summary.load_imbalance,
                                ops_comm.comm_matrix,
                                ops_comm.message_histogram,
                                detectors.stragglers,
                                detectors.late_sender,
                                detectors.serialization,
                                detectors.imbalance_root_cause,
                                detectors.efficiency_metrics,
                                detectors.pop_efficiency,
                                detectors.diagnose])
def test_op_without_device_raises_without_a_card(no_cuda, cpu_trace, op):
    with pytest.raises(RuntimeError, match="CUDA"):
        op(cpu_trace)


def test_trace_method_with_cuda_device_raises(no_cuda, cpu_trace):
    with pytest.raises(RuntimeError, match="CUDA"):
        cpu_trace.comm_matrix(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        cpu_trace.stragglers(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        cpu_trace.query().restrict_processes([0]).flat_profile(
            device="cuda")


def test_set_ops_asked_for_the_card_raise(no_cuda, cpu_trace):
    """A set op runs each member on its own device, and asked for the card
    without one it raises; a set opened without ``device=`` asks for the
    card."""
    from repro_torch import TraceSet
    ts = TraceSet([cpu_trace, cpu_trace])
    assert len(ts.regression_report()) > 0
    with pytest.raises(RuntimeError, match="CUDA"):
        ts.regression_report(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        ts.query().diff_flat_profile(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        TraceSet.open(["a.jsonl"], streaming=True)


def test_adapters_without_device_raise(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        accel.seg_sum(np.zeros(3, np.int64), np.ones(3), 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        accel.hist_counts(np.zeros(3, np.int64), 2)
