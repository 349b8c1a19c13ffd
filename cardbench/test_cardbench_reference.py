"""The plain reference against the port at toy sizes on the CPU, and the
harness's judgement: a sound run passes, the control and each fault the
cells can have fail."""

import time

import pytest
import torch

from cardbench import harness, loadgen, weights
from cardbench.kinds import train
from cardbench.reference import model as M
from cardbench.reference.precision import fp8_mm

MOE = {"name": "toy-moe", "hidden_size": 128, "intermediate_size": 128,
       "moe_intermediate_size": 32, "shared_expert_intermediate_size": 64,
       "num_experts": 8, "num_experts_per_tok": 2, "num_hidden_layers": 2,
       "num_attention_heads": 4, "num_key_value_heads": 2,
       "vocab_size": 500, "rope_theta": 1e4, "rms_norm_eps": 1e-6,
       "tie_word_embeddings": False, "torch_dtype": "bfloat16",
       "qkv_bias": True,
       "assumed": {"capacity_factor": 1.25, "padded_vocab": 512}}
DENSE = {k: v for k, v in MOE.items()
         if not k.startswith(("moe_", "shared_", "num_experts"))}
DENSE.update(name="toy-dense", assumed={"padded_vocab": 512})
TRAIN_MIX = {"form": "token_batches", "batch": 2, "seq": 128}
SEED = 2**31 + 11


def toy_run(cell: str, cfg: dict, mix: dict) -> harness.Run:
    r = harness.load_cell(cell)
    r.config, r.mix, r.seed, r.seconds = cfg, mix, SEED, 0.3
    r.device, r.t0 = "cpu", time.perf_counter()
    return r


@pytest.mark.parametrize("cfg", [MOE, DENSE], ids=["moe", "dense"])
def test_reference_matches_the_port_in_float32(cfg):
    from repro_torch.models import build_model
    from cardbench import modelcfg
    a = M.arch_from_config(cfg)
    blocks = M.param_blocks(a)
    model = build_model(modelcfg.program_config(cfg), dtype=torch.float32,
                        device="cpu")
    weights.load_into(dict(model.named_parameters()), blocks, SEED)
    p = {k: v.float() for _, b in weights.draw(blocks, SEED, "cpu")
         for k, v in b.items()}
    b = loadgen.batch(TRAIN_MIX, SEED, 0, a.vocab)
    tok = torch.from_numpy(b["tokens"])
    lab = torch.from_numpy(b["labels"])
    got, _ = model.forward(tok)
    x = p["embed"][tok]
    for i in range(a.layers):
        x = M.batch_layer(p, i, x, a)
    want = M.head_logits(p, x, a)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(model.loss(tok, lab),
                               M.loss(p, tok, lab, a, remat=False),
                               rtol=1e-5, atol=1e-5)


CELLS = [("train-qwen2moe-8k", MOE), ("train-codeqwen-8k", DENSE)]


def outcome(r):
    res = harness.execute(r)
    return res["correct"], {k: c["value"] for k, c in res["checks"].items()}


@pytest.mark.parametrize("cell,cfg", CELLS, ids=["moe", "dense"])
def test_train_sound_run_reads_below_the_control(cell, cfg):
    """At toy sizes the numbers spread wider than at the cell's (few
    tokens an expert), so the chip's limits are not the yardstick here:
    a sound run reads well below the float8 control on the numbers that
    the control is there to fail, and within the cell's limits on the
    norm gaps."""
    r = toy_run(cell, cfg, TRAIN_MIX)
    res = harness.execute(r)
    got = {k: c["value"] for k, c in res["checks"].items()}
    a = M.arch_from_config(cfg)
    blocks = M.param_blocks(a)
    ref = train.reference_run(r, a, blocks)
    ctrl = train.compare(train.reference_run(r, a, blocks, mm=fp8_mm), ref)
    assert got["grad_err"] < ctrl["grad_err"] / 2, (got, ctrl)
    for k in ("grad_gap", "delta_gap"):
        assert got[k] <= r.cell["checks"][k], (k, got)


@pytest.mark.parametrize("cell,cfg", CELLS, ids=["moe", "dense"])
def test_train_step_that_keeps_its_state_is_not_correct(cell, cfg,
                                                        monkeypatch):
    from repro_torch.runtime import trainer

    def unchanged(params, grads, state, lr, **kw):
        state.step += 1
        return state

    monkeypatch.setattr(trainer, "adamw_update", unchanged)
    ok, got = outcome(toy_run(cell, cfg, TRAIN_MIX))
    assert not ok and got["delta_gap"] == 1.0 and got["grad_gap"] == 1.0


@pytest.mark.parametrize("cell,cfg", CELLS, ids=["moe", "dense"])
def test_train_half_batch_is_not_correct(cell, cfg, monkeypatch):
    from repro_torch.models.lm import LM
    loss = LM.loss

    def half(self, tokens, labels, **kw):
        n = tokens.shape[0] // 2
        return loss(self, tokens[:n], labels[:n], **kw)

    monkeypatch.setattr(LM, "loss", half)
    ok, got = outcome(toy_run(cell, cfg, TRAIN_MIX))
    assert not ok, got


@pytest.mark.parametrize("cell,cfg", CELLS, ids=["moe", "dense"])
def test_train_control_in_float8_is_not_correct(cell, cfg):
    r = toy_run(cell, cfg, TRAIN_MIX)
    a = M.arch_from_config(cfg)
    blocks = M.param_blocks(a)
    ref = train.reference_run(r, a, blocks)
    ctrl = train.reference_run(r, a, blocks, mm=fp8_mm)
    ok, _ = harness.judge(train.compare(ctrl, ref), r.cell["checks"])
    assert not ok
