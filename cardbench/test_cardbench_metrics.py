"""Each per-layer reader on a recorded device table, the table's own
arithmetic, and BENCHMARK.json against the files that serve it."""

import json
import re
from pathlib import Path

import pytest

from cardbench import counts, devtrace, harness, loadgen, modelcfg
from cardbench.reference import model as M

HERE = Path(__file__).resolve().parent
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
MS = 1e-3


def table(device, host=(), wall=1.0):
    return devtrace.Table(sorted(device, key=lambda x: x[1]), list(host),
                          wall)


def test_busy_is_the_union_and_gaps_name_the_host():
    t = table([("k1", 0.0, 0.4), ("Memcpy HtoD", 0.3, 0.5),
               ("k2", 0.6, 0.7), ("k3", 0.9, 1.0)],
              host=[("aten::mm", 0.45, 0.65, 1), ("aten::add", 0.8, 0.85, 2),
                    ("aten::bmm", 0.75, 0.95, 1)])
    assert t.busy_s() == pytest.approx(0.7)
    assert [k[0] for k in t.kernels()] == ["k1", "k2", "k3"]
    gaps = dict(devtrace.idle_gaps(t))
    assert gaps == pytest.approx({"aten::mm": 0.1, "aten::add": 0.2})
    ops = devtrace.top_device_ops(t)
    assert ops[0] == ["k1", pytest.approx(0.4)]


def train_layer(name="qwen2-moe-a2.7b-4l"):
    a = M.arch_from_config(modelcfg.load(name))
    return {"arch": a, "steps": 10, "window_s": 8.0, "batch": 4,
            "seq": 2048, "profiled_steps": 3,
            "flops_per_step": counts.train_step_flops(a, 4, 2048)}


def train_table():
    dev = []
    t = 0.0
    for step in range(3):
        for name, dur in (("void flash_wgmma<128>", 0.2 * MS),
                          ("void bwd_delta<bf16>", 0.05 * MS),
                          ("void bwd_dkdv_wgmma<128>", 0.5 * MS),
                          ("void bwd_dq_wgmma<128>", 0.4 * MS),
                          ("ampere_bf16_gemm", 300 * MS),
                          ("Memset (Device)", 1 * MS)):
            dev.append((name, t, t + dur))
            t += dur + 10 * MS
    return table(dev, wall=t + 10 * MS)


def test_train_readers():
    tab, lay = train_table(), train_layer()
    idle = harness.reader("idle_share.train")(tab, lay)
    assert idle == pytest.approx(100 * (1 - tab.busy_s() / tab.wall_s))
    assert harness.reader("launches_per_step.train")(tab, lay) == 5
    mfu = harness.reader("mfu.train")(tab, lay)
    assert mfu == pytest.approx(100 * lay["flops_per_step"] * 10 / 8.0
                                / 989e12)
    roof = harness.reader("flash_bwd_roofline")(tab, lay)
    a = lay["arch"]
    ops, nb = counts.flash_bwd(4, 2048, 16, 16, 128)
    want = 100 * max(ops / 989e12, nb / 3.35e12) * a.layers * 3 \
        / (3 * 0.95 * MS)
    assert roof == pytest.approx(want)
    assert 0 < roof <= 100
    # a run with nothing to read gives nothing, never 0
    for name in ("idle_share.train", "launches_per_step.train",
                 "flash_bwd_roofline"):
        assert harness.reader(name)(None, lay) is None, name
    assert harness.reader("mfu.train")(tab, dict(lay, steps=0)) is None


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_names_its_files():
    assert BENCH["command"] == ["python3", "cardbench/run.py"]
    assert BENCH["paths"] == ["cardbench"]
    for c in BENCH["configs"]:
        cfg = json.loads((HERE.parent / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert all(k in cfg for k in c["reduced"])
        modelcfg.program_config(cfg)
    for w in BENCH["workloads"]:
        cell = json.loads((HERE / "workloads" / f"{w['name']}.json")
                          .read_text())
        for k in ("name", "config", "traffic", "chips", "why"):
            assert cell[k] == w[k], (w["name"], k)
        mix = loadgen.load(w["traffic"])
        assert (HERE / "traffic" / f"{mix['form']}.py").exists()
        assert (HERE / "kinds" / f"{cell['kind']}.py").exists()
        e2e = harness.metrics_of(w["name"], "end_to_end", BENCH)
        layer = harness.metrics_of(w["name"], "per_layer", BENCH)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert layer
        for m in layer:
            assert m["moves"] in {x["name"] for x in e2e}
    names = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["name"] not in names
        names.add(m["name"])
    for m in BENCH["per_layer"]:
        assert harness.reader(m["name"]) is not None
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_read_a_recorded_host_profile():
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        x = torch.ones(64, 64)
        y = x @ x
        torch.softmax(y, dim=-1)
    t = devtrace.read(prof, 1.0)
    assert t.device == [] and t.wall_s == 1.0
    names = [h[0] for h in t.host]
    assert "aten::matmul" in names and "aten::softmax" in names
    assert "aten::mm" not in names             # nested under matmul
    mm, sm = names.index("aten::matmul"), names.index("aten::softmax")
    assert t.host[mm][2] <= t.host[sm][1]
