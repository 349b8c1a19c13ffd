"""The port's dry run (``repro_torch.launch.dryrun``) on fake 256- and
512-rank meshes, each in a subprocess (``init_process_group`` is
process-global).

* qwen1.5-0.5b ``decode_32k`` on the single-pod (256) and multi-pod (512)
  meshes, the reference test's cells: a record with the reference's keys
  (read from the reference module's source, which is not imported: it
  sets ``XLA_FLAGS`` when imported), collectives counted (and
  ``CommDebugMode`` counting the same), positive compute and memory
  terms, the file written.
* qwen1.5-110b and qwen3-moe-235b-a22b at ``train_4k``: per-device FLOPs
  between 1.0 and 1.6 times 6 · active parameters · tokens / chips.
* The two FLOP counters on two matmuls of DTensors on a (2, 2) fake mesh
  against hand counts: ``FlopCounterMode`` reports the global FLOPs, the
  dry run's ``DeviceCounter`` the per-device ones.
* ``--save-hlo`` is refused; the ``SKIP`` set is the reference's.
"""

import ast
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parent.parent
REF = ROOT / "src" / "repro" / "launch" / "dryrun.py"


def _run(code: str, timeout: int = 600) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(ROOT), env=env, timeout=timeout)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    line = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


def _ref_record_keys() -> set:
    """The keys of the reference's ``record`` dict literal."""
    tree = ast.parse(REF.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "record" for t in node.targets):
            return {k.value for k in node.value.keys}
    raise AssertionError("no record in the reference's dry run")


def _ref_skip() -> set:
    tree = ast.parse(REF.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "SKIP" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError("no SKIP in the reference's dry run")


@pytest.mark.parametrize("multi,chips", [(False, 256), (True, 512)])
def test_dryrun_cell_records(tmp_path, multi, chips):
    out = _run(textwrap.dedent(f"""
        import json
        from repro_torch.launch.dryrun import run_cell
        r = run_cell("qwen1.5-0.5b", "decode_32k", {multi}, {str(tmp_path)!r})
        print("RESULT " + json.dumps(r))
    """))
    assert set(out) == _ref_record_keys()
    assert out["chips"] == chips
    assert out["mesh"] == ("pod2x16x16" if multi else "pod16x16")
    rl = out["roofline"]
    assert rl["compute_s"] > 0 and rl["memory_s"] > 0
    coll = out["collectives_schedule"]
    assert coll["total"]["count"] > 0
    assert coll["comm_debug_count"] == coll["total"]["count"]
    mem = out["memory_analysis"]
    assert mem["peak_size"] >= mem["argument_size"] > 0
    assert out["per_device"]["flops"] > 0
    saved = tmp_path / f"qwen1.5-0.5b__decode_32k__{out['mesh']}.json"
    assert json.loads(saved.read_text())["chips"] == chips


@pytest.mark.parametrize("arch", ["qwen1.5-110b", "qwen3-moe-235b-a22b"])
def test_train_4k_flops_per_device_against_6nd(arch):
    out = _run(textwrap.dedent(f"""
        import json
        from repro_torch.launch.dryrun import run_cell
        r = run_cell({arch!r}, "train_4k", False, None)
        print("RESULT " + json.dumps(r))
    """), timeout=900)
    tokens = 256 * 4096
    six_nd = 6 * out["active_params"] * tokens / out["chips"]
    ratio = out["per_device"]["flops"] / six_nd
    assert 1.0 <= ratio <= 1.6, ratio
    assert out["collectives_schedule"]["total"]["count"] > 0


def test_flop_counters_on_two_matmuls():
    out = _run(textwrap.dedent("""
        import json
        import torch
        import torch.distributed as dist
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor
        from torch.distributed.tensor.debug import CommDebugMode
        from torch.utils.flop_counter import FlopCounterMode
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.launch.dryrun import DeviceCounter
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=4)
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        with FakeTensorMode():
            x = distribute_tensor(torch.empty(64, 32), mesh,
                                  [Shard(0), Replicate()], src_data_rank=None)
            w1 = distribute_tensor(torch.empty(32, 48), mesh,
                                   [Shard(0), Shard(1)], src_data_rank=None)
            w2 = distribute_tensor(torch.empty(48, 32), mesh,
                                   [Shard(1), Shard(0)], src_data_rank=None)
            with FlopCounterMode(display=False) as fc:
                (x @ w1) @ w2
            with CommDebugMode() as comm, DeviceCounter() as dc:
                (x @ w1) @ w2
        print("RESULT " + json.dumps({
            "flop_counter": fc.get_total_flops(), "device": dc.flops,
            "colls": [c[0] for c in dc.collectives],
            "comm_debug": comm.get_total_counts()}))
    """), timeout=300)
    glob = 2 * 64 * 32 * 48 + 2 * 64 * 48 * 32
    assert out["flop_counter"] == glob
    assert out["device"] == glob // 4
    assert out["colls"] == ["all-gather", "all-gather"]
    assert out["comm_debug"] == 2


def test_save_hlo_is_refused_and_skip_is_the_reference():
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k",
                     "--save-hlo"])
    assert e.value.code == 2
    with pytest.raises(ValueError, match="HLO"):
        dryrun.run_cell("qwen1.5-0.5b", "decode_32k", False, None,
                        save_hlo=True)
    assert dryrun.SKIP == _ref_skip()
