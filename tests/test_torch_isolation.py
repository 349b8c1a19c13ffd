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


def test_import_leaves_jax_and_repro_unloaded():
    code = ("import sys, repro_torch, repro_torch.readers, "
            "repro_torch.tracegen, repro_torch.convert; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]; print(bad); sys.exit(1 if bad else 0)")
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
                                detectors.stragglers])
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


def test_adapters_without_device_raise(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        accel.seg_sum(np.zeros(3, np.int64), np.ones(3), 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        accel.hist_counts(np.zeros(3, np.int64), 2)
