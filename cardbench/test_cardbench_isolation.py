"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference imports nothing of the program."""

import ast
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

PROBE = r"""
import sys
sys.path[:0] = [{src!r}, {root!r}]
from cardbench import harness, loadgen, counts, devtrace, weights, modelcfg
from cardbench import controls
from cardbench.kinds import train
from cardbench.reference import model, precision, train as rt
import json
bench = harness.benchmark()
for m in bench["per_layer"]:
    harness.reader(m["name"])
for w in bench["workloads"]:
    loadgen.form(loadgen.load(w["traffic"]))
import repro_torch.runtime.trainer
import repro_torch.models
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_no_jax_and_no_reference_package_loaded():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(src=str(ROOT / "src"),
                                            root=str(ROOT))],
        capture_output=True, text=True, env=env, timeout=120, check=True)
    import json
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top and "cardbench" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}, top


def imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_only_torch_and_itself():
    for path in sorted((HERE / "reference").glob("*.py")):
        for name in imported(path):
            top = name.split(".")[0]
            assert top in {"torch", "math", "dataclasses", "typing",
                           "__future__", "numpy"}, (path.name, name)


def test_no_module_of_the_harness_imports_jax_or_the_jax_package():
    for path in sorted(HERE.rglob("*.py")):
        for name in imported(path):
            assert name.split(".")[0] not in {"jax", "jaxlib", "flax",
                                              "repro", "benchmarks"}, \
                (path, name)
