"""Training cells: ``repro_torch.runtime.trainer.Trainer.train_one`` on
a fresh batch of the mix each step (``loadgen.batch``, the mix's form).

Set-up builds one trainer (its model and AdamW state) in bfloat16, copies
the benchmark's weights into it, and drives it through its first three
steps with the window's own call and feed; the first gradient, as the
optimizer took it, is read from AdamW's first moment after step 1
(m = (1 - b1) g), and the parameters' change after step 3, against the
weights drawn again from the seed.  The window then runs steps from step
4 on for ``seconds``: its rate is the tokens of every step completed over
the whole window.  A traced run profiles three steps of it.  After the
window the trainer is freed and the reference runs the same three steps
from the same weights and batches (:mod:`cardbench.reference.train`).
"""

from __future__ import annotations

import gc
import math
import statistics
import time
from typing import Dict, List

from .. import counts, devtrace, loadgen, modelcfg, weights
from ..harness import Outcome, Run
from ..reference import model as ref_model
from ..reference import train as ref_train

CHECK_STEPS = 3
PROFILED_STEPS = 3
#: elements of each leaf whose first gradient is compared
SAMPLE = 4096
#: leaves whose reference gradient norm is under this share of the median
#: leaf's are left out of the comparison of norms
SMALL_LEAF = 1e-3


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers a training run can be judged by, over the leaves that
    count (``kept``).  ``loss_gap``: the largest relative gap of a step's
    loss.  ``grad_gap`` / ``delta_gap``: the largest gap of a leaf's norm
    of the first gradient / of the change after the steps, against the
    reference's norm of that leaf or of the median leaf, whichever is
    larger.  ``grad_err``: the median leaf's relative difference
    ||program - reference|| / ||reference|| of the first gradient, on the
    elements of the leaf that the seed samples."""
    import numpy as np
    out = {"loss_gap": max(abs(p - r) / abs(r) for p, r in
                           zip(prog["losses"], ref["losses"]))}
    kept = counted(ref)
    for key, name in (("grad_norms", "grad_gap"),
                      ("delta_norms", "delta_gap")):
        r = {k: ref[key][k] for k in kept}
        med = statistics.median(r.values())
        out[name] = max(abs(prog[key][k] - r[k]) / max(r[k], med)
                        for k in kept)
    out["grad_err"] = statistics.median(
        float(np.linalg.norm(prog["grad_sample"][k] - ref["grad_sample"][k])
              / max(np.linalg.norm(ref["grad_sample"][k]), 1e-30))
        for k in kept)
    return out


def counted(ref: dict) -> List[str]:
    """The leaves compared: those whose reference gradient norm is at
    least ``SMALL_LEAF`` of the median leaf's."""
    g = ref["grad_norms"]
    med = statistics.median(g.values())
    return [k for k, v in g.items() if v >= SMALL_LEAF * med]


def sample_index(blocks, seed: int, device) -> Dict:
    """Per leaf, ``SAMPLE`` element indices drawn from the seed."""
    import numpy as np
    import torch
    out = {}
    for i, (name, n) in enumerate(
            (k, math.prod(s)) for _, b in blocks for k, s in b.items()):
        rng = np.random.default_rng([seed % (1 << 63), 6, i])
        out[name] = torch.from_numpy(
            rng.integers(0, n, size=min(SAMPLE, n))).to(device)
    return out


def worst(prog: dict, ref: dict, key: str) -> str:
    g_ref = ref["grad_norms"]
    kept = counted(ref)
    med = statistics.median(ref[key][k] for k in kept)
    k = max(kept, key=lambda k: abs(prog[key][k] - ref[key][k])
            / max(ref[key][k], med))
    return (f"{key}: worst leaf {k} program {prog[key][k]!r} reference "
            f"{ref[key][k]!r}; {len(g_ref) - len(kept)} leaves left out")


def batches_on(mix: dict, seed: int, vocab: int, n: int, device) -> List:
    import torch
    out = []
    for i in range(n):
        b = loadgen.batch(mix, seed, i, vocab)
        out.append({k: torch.from_numpy(v).to(device) for k, v in b.items()})
    return out


def reference_run(r: Run, a, blocks, mm=ref_model.plain_mm,
                  rows: slice = slice(None)) -> dict:
    """The reference's three steps from the seed's weights and batches
    (``rows`` of each batch)."""
    bs = batches_on(r.mix, r.seed, a.vocab, CHECK_STEPS, r.device)
    bs = [{k: v[rows] for k, v in b.items()} for b in bs]
    return ref_train.run_steps(weights.draw(blocks, r.seed, r.device), bs,
                               a, r.cell["optimizer"], mm,
                               sample=sample_index(blocks, r.seed, r.device))


def run(r: Run) -> Outcome:
    import torch
    prog, st = program_run(r)
    t = time.perf_counter()
    ref = reference_run(r, st["arch"], st["blocks"])
    ref_s = time.perf_counter() - t
    checks = compare(prog, ref)
    notes = [", ".join(f"{k} {v!r}" for k, v in checks.items()
                       if k not in r.cell["checks"]) + " (not compared)",
             f"setup {st['setup_s']:.3f} s (check readings "
             f"{st['check_s']:.3f} s apart), window {st['window_s']:.3f} s, "
             f"{st['steps']} steps, reference {ref_s:.3f} s",
             f"losses program {prog['losses']} reference {ref['losses']}",
             worst(prog, ref, "grad_norms"), worst(prog, ref, "delta_norms")]
    a, (B, S), n = st["arch"], st["shape"], st["steps"]
    return Outcome(
        end_to_end={"train_tokens_per_s": n * B * S / st["window_s"],
                    "setup_s": st["setup_s"]},
        attempted=n, failed=st["failed"], checks=checks,
        memory_peak_bytes=st["peak"], table=st["table"],
        layer={"arch": a, "steps": n, "window_s": st["window_s"],
               "batch": B, "seq": S, "profiled_steps": PROFILED_STEPS,
               "flops_per_step": counts.train_step_flops(a, B, S)},
        notes=notes)


def program_run(r: Run):
    """Set-up, the check steps and the window; the trainer freed after.
    Returns the program's readings and the run's own numbers."""
    import torch
    from repro_torch.runtime.trainer import Trainer, TrainLoopConfig

    a = ref_model.arch_from_config(r.config)
    blocks = ref_model.param_blocks(a)
    opt = r.cell["optimizer"]
    loop = TrainLoopConfig(
        steps=opt["total_steps"], peak_lr=opt["peak_lr"],
        warmup_steps=opt["warmup_steps"], weight_decay=opt["weight_decay"],
        clip_norm=opt["clip_norm"], ckpt_every=0, dtype=torch.bfloat16)
    trainer = Trainer(modelcfg.program_config(r.config), loop,
                      device=r.device)
    weights.load_into(trainer.params, blocks, r.seed)

    def batch(i):
        return loadgen.batch(r.mix, r.seed, i, a.vocab)

    first = batch(0)
    shape = first["tokens"].shape
    prog = {"losses": [trainer.train_one(first, 0)]}
    t = time.perf_counter()
    idx = sample_index(blocks, r.seed, r.device)
    with torch.no_grad():
        m1 = trainer.opt_state.m
        prog["grad_norms"] = {
            k: float(torch.linalg.vector_norm(m)) / (1 - opt["b1"])
            for k, m in m1.items()}
        prog["grad_sample"] = {
            k: m.view(-1)[idx[k]].double().cpu().numpy() / (1 - opt["b1"])
            for k, m in m1.items()}
    check_s = time.perf_counter() - t
    for i in range(1, CHECK_STEPS):
        prog["losses"].append(trainer.train_one(batch(i), i))
    t = time.perf_counter()
    prog["delta_norms"] = {}
    with torch.no_grad():
        for _, leaves in weights.draw(blocks, r.seed, r.device):
            for k, w0 in leaves.items():
                prog["delta_norms"][k] = float(torch.linalg.vector_norm(
                    trainer.params[k].float() - w0.float()))
            del leaves
    check_s += time.perf_counter() - t
    setup_s = time.perf_counter() - r.t0 - check_s

    cap = devtrace.Capture() if r.trace else None
    step, n, failed = CHECK_STEPS, 0, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < r.seconds or (
            cap is not None and not cap.stopped):
        if cap is not None and n == 2:
            cap.start()
        loss = trainer.train_one(batch(step), step)
        failed += not (loss == loss and abs(loss) < float("inf"))
        if cap is not None and n == 1 + PROFILED_STEPS:
            cap.stop()
        step += 1
        n += 1
    window_s = time.perf_counter() - t0
    table = cap.finish() if cap else None

    peak = torch.cuda.max_memory_allocated() if r.device == "cuda" else 0
    del trainer
    gc.collect()
    if r.device == "cuda":
        torch.cuda.empty_cache()
    return prog, {"arch": a, "blocks": blocks, "shape": shape,
                  "setup_s": setup_s,
                  "check_s": check_s, "window_s": window_s, "steps": n,
                  "failed": failed, "peak": peak, "table": table}
