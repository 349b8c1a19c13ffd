"""cardbench: the benchmark of the PyTorch and CUDA port on one H100.

Run one cell once, from the root of a checkout::

    python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

It puts ``src`` on the path, builds the port's kernels on first use into
``build/repro_torch/`` (the port's own cache, inside the checkout), sets
up (weights drawn from the seed on the card, the cell's shapes warmed up),
measures for ``--seconds``, judges what the timed path produced against
the plain reference in ``cardbench/reference/``, and prints one JSON line
last: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and ``checks`` (each number
compared beside its limit, also the last lines on standard error).  It
exits non-zero without printing a result when the machine has fewer CUDA
devices than the cell asks for, and when JAX or the JAX package was
loaded.

The cells (``workloads/``):

* ``train-qwen2moe-8k``: qwen2-moe-a2.7b cut to 4 layers, 4 x 2,048
  tokens a step through ``Trainer.train_one``;
* ``train-codeqwen-8k``: codeqwen1.5-7b cut to 8 layers, as the first.

Adding to the benchmark takes new files only:

* a configuration: ``configs/<name>.json``, the published keys as run,
  ``source``, ``reduced`` (each changed key and why), ``assumed``;
* a traffic mix: ``traffic/<name>.json``, naming its ``form`` and giving
  that form's parameters; a new form (an arrival law, a length law, a
  kind of batch) is a generator module ``traffic/<form>.py`` of its own,
  found by name (``loadgen.py``);
* a cell: ``workloads/<name>.json``, naming its ``config``, ``traffic``,
  ``kind`` (a module in ``kinds/``), ``chips``, ``why`` and the limits of
  its ``checks``; then its entry in ``BENCHMARK.json``;
* a per-layer metric: ``metrics/<name>.py`` with ``read(table, layer)``,
  and its entry in ``BENCHMARK.json``.

``controls.py`` reads the control's and the faults' numbers on the chip.
"""

import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

from cardbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
