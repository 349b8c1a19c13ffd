"""The port's LM training path against the JAX reference on the CPU.

``pipit-lm-100m-smoke`` in float32 with the reference's own weights
(``LM.init``, seed 0) carried across by ``convert.params_from_jax``: the
loss and every gradient of ``LM.loss`` against ``jax.value_and_grad`` of
the reference model's (atol 1e-5 x the largest magnitude: f32 matmuls
summed in another order); three ``Trainer`` steps against the reference
``Trainer`` on the same batches from the same parameters and optimizer
state (``convert.adamw_state_from_jax``), losses and parameters within
1e-5 relative (within 1e-5 x the leaf's largest magnitude for the
parameters); ``microbatches=2`` against ``microbatches=1``.  The pieces
on their own: ``softmax_xent`` on padded and negative labels,
``cosine_schedule`` and ``adamw_update`` step by step, the checkpoint
manager (round trip, integrity, GC, an uncommitted step ignored, bf16
bits), fault restart, straggler detection, the training launcher and
``train_traced``.  Every kernel runs its plain version here (CPU tensors).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro.models.layers import softmax_xent as jax_xent
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import cosine_schedule as jax_cosine
from repro.runtime import Trainer as JaxTrainer
from repro.runtime import TrainLoopConfig as JaxLoop
from repro_torch import Trace
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import adamw_state_from_jax, params_from_jax
from repro_torch.data import SyntheticLMStream
from repro_torch.launch import train as launch_train
from repro_torch.launch.train_traced import train_traced
from repro_torch.models import build_model
from repro_torch.models.layers import softmax_xent
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule
from repro_torch.runtime import FaultInjector, Trainer, TrainLoopConfig

ARCH = "pipit-lm-100m"
CFG = get_smoke_config(ARCH)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def ref():
    cfg = jax_smoke_config(ARCH)
    model = jax_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.float32)
    return cfg, model, params


def _batch(seed=0, B=4, S=16):
    return SyntheticLMStream(CFG.vocab, B, S, seed=seed).batch_at(3)


def test_configs_match_reference():
    for ours, theirs in ((get_smoke_config(ARCH), jax_smoke_config(ARCH)),
                         (get_config(ARCH), jax_config(ARCH))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.param_count() == theirs.param_count()
    full = get_config(ARCH)
    assert (full.n_layers, full.d_model, full.hd, full.padded_vocab) == \
        (12, 768, 64, 32000)


@pytest.mark.parametrize("vocab,padded", [(500, 512), (512, 512)])
def test_softmax_xent_masks_padded_and_negative_labels(vocab, padded):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, padded)) * 4).astype(np.float32)
    labels = rng.integers(0, vocab, (3, 7)).astype(np.int32)
    labels[0, :3] = -1
    labels[1, 2] = padded - 1          # >= vocab when the vocab is padded
    labels[2, 5] = -7
    got = softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels),
                       vocab)
    want = jax_xent(jnp.asarray(logits), jnp.asarray(labels), vocab)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    none = np.full((3, 7), -1, np.int32)
    assert float(softmax_xent(torch.from_numpy(logits),
                              torch.from_numpy(none), vocab)) == 0.0


def test_softmax_xent_bf16_logits_in_f32():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 5, 512)).astype(np.float32)
    labels = rng.integers(0, 512, (2, 5)).astype(np.int32)
    tl = torch.from_numpy(logits).bfloat16()
    got = softmax_xent(tl, torch.from_numpy(labels), 512)
    want = jax_xent(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(labels),
                    512)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("warmup,total", [(5, 50), (1, 3), (20, 10)])
def test_cosine_schedule_step_by_step(warmup, total):
    for step in range(total + 3):
        got = cosine_schedule(step, 3e-4, warmup, total)
        want = jax_cosine(jnp.int32(step), 3e-4, warmup, total)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("clip", [1.0, None, 1e-3])
def test_adamw_update_step_by_step(clip):
    rng = np.random.default_rng(2)
    shapes = {"embed": (6, 4), "final_ln": (4,), "w": (4, 3)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    ours = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = adamw_init(ours)
    theirs = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jax_adamw_init(theirs)
    for step in range(5):
        grads = {k: rng.standard_normal(s).astype(np.float32)
                 for k, s in shapes.items()}
        lr = float(jax_cosine(jnp.int32(step), 1e-2, 2, 5))
        state = adamw_update(ours, {k: torch.from_numpy(g.copy())
                                    for k, g in grads.items()}, state,
                             cosine_schedule(step, 1e-2, 2, 5),
                             clip_norm=clip)
        theirs, jstate = jax_adamw_update(
            theirs, {k: jnp.asarray(g) for k, g in grads.items()}, jstate,
            lr, clip_norm=clip)
        assert state.step == int(jstate.step) == step + 1
        for k in shapes:
            np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs[k]),
                                       rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(state.m[k].numpy(),
                                       np.asarray(jstate.m[k]), rtol=1e-5,
                                       atol=1e-8)
            np.testing.assert_allclose(state.v[k].numpy(),
                                       np.asarray(jstate.v[k]), rtol=1e-5,
                                       atol=1e-10)


def test_adamw_chunked_update_gives_the_same_bits(monkeypatch):
    """A leaf above ``adamw.CHUNK`` elements is updated in flat pieces (its
    f32 temporaries a piece's size): every op is elementwise, so three
    steps give the whole-leaf update's parameters and moments bit for bit,
    for a bf16 leaf, an f32 leaf and a non-contiguous gradient."""
    from repro_torch.optim import adamw
    rng = np.random.default_rng(4)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))

    params = {"emb": draw(300, 70).bfloat16(), "w": draw(64, 50),
              "b": draw(7)}
    grads = {"emb": draw(300, 70), "w": draw(50, 64).T, "b": draw(7)}
    out = []
    for chunk in (adamw.CHUNK, 1000):
        monkeypatch.setattr(adamw, "CHUNK", chunk)
        ps = {k: p.clone() for k, p in params.items()}
        st = adamw_init(ps)
        for _ in range(3):
            adamw_update(ps, {k: g.clone() for k, g in grads.items()}, st,
                         1e-2)
        out.append((ps, st))
    (p1, s1), (p2, s2) = out
    for k in params:
        for a, b in ((p1[k], p2[k]), (s1.m[k], s2.m[k]), (s1.v[k], s2.v[k])):
            assert torch.equal(a, b), k


def test_adamw_bf16_parameters_update_in_f32():
    p = {"w": torch.full((4,), 1.0, dtype=torch.bfloat16)}
    state = adamw_init(p)
    assert state.m["w"].dtype == torch.float32
    adamw_update(p, {"w": torch.full((4,), 0.5)}, state, 1e-2)
    jp, js = jax_adamw_update({"w": jnp.full((4,), 1.0, jnp.bfloat16)},
                              {"w": jnp.full((4,), 0.5, jnp.float32)},
                              jax_adamw_init({"w": jnp.ones(4,
                                                            jnp.bfloat16)}),
                              1e-2)
    assert p["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(p["w"].float().numpy(),
                                  np.asarray(jp["w"], np.float32))


def test_loss_and_every_gradient_match_jax(ref):
    cfg, model, params = ref
    batch = _batch()
    loss, grads = jax.value_and_grad(model.loss)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    ours = build_model(CFG, device="cpu")
    ours.load_state_dict(params_from_jax(_np_tree(params), CFG))
    ours.requires_grad_(True)
    tok = torch.from_numpy(batch["tokens"]).long()
    lab = torch.from_numpy(batch["labels"]).long()
    got = ours.loss(tok, lab)
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-6)
    names = [k for k, _ in ours.named_parameters()]
    gs = torch.autograd.grad(got, [p for _, p in ours.named_parameters()])
    want = params_from_jax(_np_tree(grads), CFG)
    assert set(names) == set(want)
    for k, g in zip(names, gs):
        w = want[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * max(float(np.abs(w).max()),
                                                   1e-12), err_msg=k)


def test_serving_entry_points_stay_without_grad(ref):
    ours = build_model(CFG, device="cpu")
    ours.load_state_dict(params_from_jax(_np_tree(ref[2]), CFG))
    ours.requires_grad_(True)
    tok = torch.from_numpy(_batch()["tokens"]).long()
    logits, _ = ours(tok)
    cache, last, pos = ours.prefill(tok, 32)
    step, _ = ours.decode_step(cache, tok[:, :1], pos, 32)
    assert all(t.grad_fn is None for t in (logits, last, step))


def _ref_trainer(ref, loop):
    """The reference trainer from the fixture's parameters (copied: its
    jitted step donates its inputs)."""
    tr = JaxTrainer(ref[0], loop)
    tr.params = jax.tree_util.tree_map(jnp.array, _np_tree(ref[2]))
    tr.opt_state = jax_adamw_init(tr.params)
    return tr


def _port_trainer(ref, loop):
    tr = Trainer(CFG, loop, device="cpu")
    tr.model.load_state_dict(params_from_jax(_np_tree(ref[2]), CFG))
    tr.opt_state = adamw_state_from_jax(
        _np_tree(jax_adamw_init(ref[2])), CFG)
    return tr


def test_three_trainer_steps_match_the_reference(ref):
    """At the loop's default peak learning rate (3e-4, one warm-up step).
    The parameters' difference scales with the rate: Adam divides each
    gradient by its own magnitude, so an element whose gradient is a few
    times ``eps`` (one ``layers.1.w_up`` element at -3.1e-8 here, its
    gradient a few ulps apart between the two packages' f32 sums) moves by
    up to ``lr`` times its relative difference; at 1e-2 that element alone
    is 2e-4 apart (1.7e-5 of the leaf's norm) while every other element of
    every leaf is within 1.4e-7."""
    kw = dict(steps=3, warmup_steps=1)
    theirs = _ref_trainer(ref, JaxLoop(**kw))
    ours = _port_trainer(ref, TrainLoopConfig(**kw))
    stream = SyntheticLMStream(CFG.vocab, 4, 16, seed=1)
    for step in range(3):
        batch = stream.batch_at(step)
        a = ours.train_one(batch, step)
        b = theirs.train_one(batch, step)
        np.testing.assert_allclose(a, b, rtol=1e-5)
    stream.close()
    assert ours.opt_state.step == int(theirs.opt_state.step) == 3
    for mine, theirs_tree in ((ours.params, theirs.params),
                              (ours.opt_state.m, theirs.opt_state.m),
                              (ours.opt_state.v, theirs.opt_state.v)):
        want = params_from_jax(_np_tree(theirs_tree), CFG)
        for k, t in mine.items():
            _rel_close(t.detach().numpy(), want[k].numpy(), k)


def _rel_close(got, want, what, tol=1e-5):
    """Within ``tol`` relative, leaf by leaf in the 2-norm: Adam divides
    each gradient by its own running magnitude, so where f32 sums in
    another order leave a near-zero gradient a few ulps apart, that one
    element moves by up to ``lr`` times the relative difference."""
    err = float(np.linalg.norm(got - want)) / max(
        float(np.linalg.norm(want)), 1e-30)
    assert err <= tol, (what, err)


def test_microbatches_two_match_one(ref):
    """M = 2 gradient accumulation (f32 buffers) against M = 1 on the
    same global batch, no clipping: the same parameters to f32 rounding
    (the reference holds its own to 5e-3)."""
    out = []
    for M in (1, 2):
        tr = _port_trainer(ref, TrainLoopConfig(
            steps=1, microbatches=M, peak_lr=1e-3, clip_norm=None))
        tr.train_one(_batch(seed=2, B=8), 0)
        out.append({k: p.detach().clone() for k, p in tr.params.items()})
    for k in out[0]:
        np.testing.assert_allclose(out[1][k].numpy(), out[0][k].numpy(),
                                   rtol=0, atol=1e-5)


def test_microbatch_gradients_accumulate_in_f32():
    """With bf16 parameters the summed microbatch gradients stay f32."""
    tr = Trainer(CFG, TrainLoopConfig(steps=1, microbatches=2,
                                      dtype=torch.bfloat16), device="cpu")
    b = _batch(B=4)
    loss, grads = tr._grads(torch.from_numpy(b["tokens"]).long(),
                            torch.from_numpy(b["labels"]).long())
    assert all(g.dtype == torch.float32 for g in grads.values())
    assert all(p.dtype == torch.bfloat16 for p in tr.params.values())
    assert np.isfinite(float(loss))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_integrity(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    tree = {"a": torch.arange(10, dtype=torch.float32),
            "b": {"c": torch.ones((3, 4), dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}
    mgr.save(5, tree)
    mgr.save(9, tree)
    assert mgr.all_steps() == [5, 9]
    out = mgr.restore(9, tree)
    np.testing.assert_array_equal(out["a"].numpy(), np.arange(10))
    assert out["b"]["c"].dtype == torch.bfloat16
    assert int(out["step"]) == 7
    path = os.path.join(str(tmp_path), "step_00000009", "arrays.npz")
    data = dict(np.load(path))
    data["a"] = data["a"] + 1
    np.savez(path, **data)
    with pytest.raises(IOError):
        mgr.restore(9, tree)


def test_checkpoint_keeps_bf16_bits(tmp_path):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((5, 7)).astype(
        np.float32)).bfloat16()
    x[0, 0] = float("nan")
    x[0, 1] = float("-inf")
    x[0, 2] = -0.0
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    mgr.save(1, {"params": {"x": x}}, extra={"model": "m"})
    mgr.wait()
    man = mgr.manifest(1)
    assert man["leaves"]["params/x"]["dtype"] == "bfloat16"
    assert man["extra"] == {"model": "m"}
    got = mgr.restore(1, {"params": {"x": x}})["params"]["x"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), x.view(torch.int16))


def test_checkpoint_gc_keeps_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.zeros(2)})
    assert mgr.all_steps() == [3, 4]


def test_uncommitted_checkpoint_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_write=False)
    mgr.save(1, {"x": torch.zeros(2)})
    os.makedirs(os.path.join(str(tmp_path), "step_00000007"))
    assert mgr.latest_step() == 1


def test_checkpoint_layout_matches_the_reference(tmp_path):
    """The same files and manifest keys as the reference's manager."""
    from repro.checkpoint import CheckpointManager as JaxManager
    a, b = tmp_path / "port", tmp_path / "ref"
    CheckpointManager(str(a), async_write=False).save(
        3, {"p": {"w": torch.ones(2, 3)}}, extra={"model": "x"})
    JaxManager(str(b), async_write=False).save(
        3, {"p": {"w": jnp.ones((2, 3))}}, extra={"model": "x"})
    for d in (a, b):
        assert sorted(os.listdir(d / "step_00000003")) == \
            ["COMMITTED", "arrays.npz", "manifest.json"]
    ma = json.loads((a / "step_00000003" / "manifest.json").read_text())
    mb = json.loads((b / "step_00000003" / "manifest.json").read_text())
    assert ma == mb


def test_trainer_checkpoint_restores_params_and_moments(tmp_path):
    loop = TrainLoopConfig(steps=2, ckpt_every=2, ckpt_dir=str(tmp_path),
                           warmup_steps=1)
    tr = Trainer(CFG, loop, device="cpu")
    stream = SyntheticLMStream(CFG.vocab, 4, 16)
    tr.run(stream)
    stream.close()
    keys = set(CheckpointManager(str(tmp_path)).manifest(2)["leaves"])
    assert "opt/step" in keys and "params/embed" in keys
    assert "opt/m/layers.0.wq" in keys and "opt/v/final_ln" in keys
    saved = {k: p.detach().clone() for k, p in tr.params.items()}
    m = {k: t.clone() for k, t in tr.opt_state.m.items()}
    for p in tr.params.values():
        p.data.zero_()
    tr.opt_state.step = 0
    assert tr.restore_latest() and tr.step == 2 and tr.opt_state.step == 2
    for k in saved:
        assert torch.equal(tr.params[k].detach(), saved[k])
        assert torch.equal(tr.opt_state.m[k], m[k])


# ---------------------------------------------------------------------------
# the run: faults, stragglers, launchers
# ---------------------------------------------------------------------------

def test_fault_restart_resumes_from_checkpoint(tmp_path):
    loop = TrainLoopConfig(steps=10, ckpt_every=3, ckpt_dir=str(tmp_path),
                           peak_lr=1e-3, warmup_steps=2)
    tr = Trainer(CFG, loop, device="cpu")
    stream = SyntheticLMStream(CFG.vocab, batch=4, seq_len=16)
    out = tr.run(stream, fault=FaultInjector(fail_at_steps=[5]))
    stream.close()
    assert out["restarts"] == 1 and out["steps"] == 10
    assert len(out["losses"]) == 10 + 5 - 3
    assert all(np.isfinite(out["losses"]))
    names = set(tr.tracer.name)
    assert {"fault", "restore", "checkpoint", "train_step", "data_wait",
            "init", "train"} <= names


def test_fault_with_no_checkpoint_reinitialises_from_the_seed(tmp_path):
    loop = TrainLoopConfig(steps=3, ckpt_every=0, warmup_steps=1)
    tr = Trainer(CFG, loop, device="cpu")
    first = {k: p.detach().clone() for k, p in tr.params.items()}
    stream = SyntheticLMStream(CFG.vocab, batch=4, seq_len=16)
    seen = []
    tr.train_one = (lambda b, s, f=None, _t=tr.train_one:
                    seen.append({k: p.detach().clone()
                                 for k, p in tr.params.items()})
                    or _t(b, s, f))
    out = tr.run(stream, fault=FaultInjector([1]))
    stream.close()
    assert out["restarts"] == 1 and out["steps"] == 3
    # the step after the fault starts again from the seed's parameters
    for k in first:
        assert torch.equal(seen[2][k], first[k])


def test_straggler_detection():
    tr = Trainer(CFG, TrainLoopConfig(steps=1, straggler_factor=2.0),
                 device="cpu")
    flagged = []
    tr.straggler_callback = lambda s, ratio: flagged.append((s, ratio))
    for step, dt in enumerate([1.0, 1.0, 1.0, 1.0, 5.0, 1.0]):
        tr._observe_step_time(step, dt)
    assert tr.straggler_events == 1 and flagged[0][0] == 4
    assert tr.tracer.name.count("straggler_suspected") == 1


def test_trainer_refuses_a_card_it_does_not_have():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        Trainer(CFG, TrainLoopConfig(steps=1))


def test_train_launcher_summary(tmp_path, capsys):
    trace = tmp_path / "t.jsonl"
    out = launch_train.main(["--smoke", "--steps", "3", "--batch", "2",
                             "--seq", "16", "--f32", "--device", "cpu",
                             "--trace", str(trace)])
    assert set(out) == {"arch", "steps", "loss_first", "loss_last",
                        "mean_step_time_s", "straggler_events"}
    assert out["steps"] == 3 and out["arch"] == "pipit-lm-100m-smoke"
    t = Trace.open(str(trace), device="cpu")
    assert "train_step" in set(np.asarray(t.flat_profile()["Name"]))


def test_train_traced_at_smoke_size(tmp_path):
    run = train_traced(steps=8, batch=4, seq=16, smoke=True, fault_at=4,
                       ckpt_every=2, ckpt_dir=str(tmp_path), device="cpu")
    assert run.summary["restarts"] == 1 and run.summary["steps"] == 8
    names = set(np.asarray(run.flat_profile["Name"]).astype(str))
    assert {"train_step", "data_wait", "checkpoint", "restore"} <= names
    assert len(run.time_profile) == 8
    counts = dict(zip(np.asarray(run.flat_profile["Name"]).astype(str),
                      np.asarray(run.flat_profile["count"])))
    assert counts["train_step"] == len(run.summary["losses"]) + 1
