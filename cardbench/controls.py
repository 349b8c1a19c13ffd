"""The numbers that set the upper ends of a cell's limits, read on the
chip at the cell's own size (not part of a benchmark run)::

    python3 cardbench/controls.py --workload <cell> --seeds 11 12 13 \
        [--seconds 20]

Training cells: for each seed, the program's readings (its set-up and
check steps, a window of ``--seconds``), the reference's three steps in
float32 (the judge), then the reference put in the program's place and compared as the program
is: the control (the reference with every product in float8, the step
below the configuration's bfloat16) and the half-batch fault (the
reference on half of each batch, the mean over that half).  A state left
unchanged reads 1 on ``grad_gap`` and ``delta_gap`` by their definition
and needs no run.

One JSON line a reading: {"cell", "seed", "what", numbers...}.
``--only-program`` reads the program's numbers alone, for more seeds.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

from cardbench import harness  # noqa: E402
from cardbench.reference import model as ref_model  # noqa: E402
from cardbench.reference.precision import fp8_mm  # noqa: E402


def emit(**kw):
    print(json.dumps(kw), flush=True)


def train_controls(r, only_program: bool = False) -> None:
    from cardbench.kinds import train
    a = ref_model.arch_from_config(r.config)
    blocks = ref_model.param_blocks(a)
    prog, st = train.program_run(r)
    ref = train.reference_run(r, a, blocks)
    emit(cell=r.cell["name"], seed=r.seed, what="program",
         **train.compare(prog, ref))
    if only_program:
        return
    for what, kw in (("control_fp8", {"mm": fp8_mm}),
                     ("fault_half_batch",
                      {"rows": slice(0, st["shape"][0] // 2)})):
        got = train.reference_run(r, a, blocks, **kw)
        emit(cell=r.cell["name"], seed=r.seed, what=what,
             **train.compare(got, ref), losses=got["losses"],
             ref_losses=ref["losses"])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--only-program", action="store_true",
                    help="read the program's numbers alone")
    args = ap.parse_args()
    for seed in args.seeds:
        r = harness.load_cell(args.workload)
        r.seed, r.seconds, r.t0 = seed, args.seconds, time.perf_counter()
        {"train": train_controls}[r.cell["kind"]](r, args.only_program)
        import torch
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
