"""The port's ``Trainer`` on the MoE, encoder-decoder and VLM families
against the reference ``Trainer`` on the CPU.

qwen2-moe-a2.7b-smoke and qwen3-moe-235b-a22b-smoke (the router through
its ``autograd.Function``, the backward's plain version), whisper-medium-
smoke with seeded ``frames`` and phi-3-vision-4.2b-smoke with seeded
``img_embeds`` in the batch: three steps from the reference's seed-0
float32 weights (``convert.params_from_jax``) and its AdamW state
(``convert.adamw_state_from_jax``) on the same batches, as
``tests/test_torch_train.py::test_three_trainer_steps_match_the_reference``
holds pipit-lm-100m: losses within 1e-5 relative, and the parameters and
both moments leaf by leaf within 1e-5 relative in the 2-norm.  The
reference's step hands the whole batch to ``model.loss``; the port's
passes the batch's extras as keywords, split into the microbatches with
the tokens, so two microbatches give one's parameters to f32 rounding.
Every kernel runs its plain version here (CPU tensors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw_init as jax_adamw_init
from repro.runtime import Trainer as JaxTrainer
from repro.runtime import TrainLoopConfig as JaxLoop
from repro_torch.convert import adamw_state_from_jax, params_from_jax
from repro_torch.data import SyntheticLMStream
from repro_torch.runtime import Trainer, TrainLoopConfig
from test_torch_encdec import pair

FAMILIES = ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b", "whisper-medium",
            "phi-3-vision-4.2b"]
B, S = 4, 16


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(cfg, step):
    """``SyntheticLMStream``'s batch at ``step`` and, by family, seeded
    float32 ``frames`` or ``img_embeds`` (NumPy, as a data loader hands
    them over)."""
    stream = SyntheticLMStream(cfg.vocab, B, S, seed=1)
    out = stream.batch_at(step)
    stream.close()
    rng = np.random.default_rng(100 + step)
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    if cfg.img_tokens:
        out["img_embeds"] = rng.standard_normal(
            (B, cfg.img_tokens, cfg.d_model)).astype(np.float32)
    return out


def _port_trainer(arch, loop):
    _jcfg, _jm, params, cfg, _model, sd = pair(arch)
    tr = Trainer(cfg, loop, device="cpu")
    tr.model.load_state_dict(sd)
    tr.opt_state = adamw_state_from_jax(_np_tree(jax_adamw_init(params)),
                                        cfg)
    return tr


def _rel_close(got, want, what, tol=1e-5):
    err = float(np.linalg.norm(got - want)) / max(
        float(np.linalg.norm(want)), 1e-30)
    assert err <= tol, (what, err)


#: the parameters' gate for a leaf that starts at zero (the QKV biases):
#: after three steps its value is Adam's update alone, and an element whose
#: gradient is a few ulps moves by up to ``lr`` times its relative
#: difference (the key biases under RoPE: 2.8e-5 and 6.6e-5 measured), where
#: every other leaf's norm carries its initial value
ZERO_INIT_TOL = 1e-4
#: a leaf whose first moment stays below this share of the model's largest
#: |m| in both packages has an exact gradient of zero: whisper's encoder key
#: bias (attention without RoPE is unchanged by a bias every key of a row
#: shares) and its never-read cross-attention biases ``x_bk`` / ``x_bv``
#: (zero in both); its m and v are rounding noise, held to that, and its
#: values move by at most lr a step
NOISE_SHARE = 1e-6


@pytest.mark.parametrize("arch", FAMILIES)
def test_three_trainer_steps_match_the_reference(arch):
    """Three steps at the loop's default peak rate (3e-4, one warm-up
    step) in both packages; whisper and phi-3-vision fail without their
    extras reaching the port's loss (whisper raises for want of frames,
    phi-3's loss leaves out its image rows).  Every leaf is held within
    1e-5 but those :data:`ZERO_INIT_TOL` and :data:`NOISE_SHARE`
    describe."""
    jcfg, _jm, params, cfg, _model, sd = pair(arch)
    kw = dict(steps=3, warmup_steps=1)
    theirs = JaxTrainer(jcfg, JaxLoop(**kw))
    theirs.params = jax.tree_util.tree_map(jnp.array, _np_tree(params))
    theirs.opt_state = jax_adamw_init(theirs.params)
    ours = _port_trainer(arch, TrainLoopConfig(**kw))
    for step in range(3):
        batch = _batch(cfg, step)
        a = ours.train_one(batch, step)
        b = theirs.train_one(batch, step)
        np.testing.assert_allclose(a, b, rtol=1e-5)
    assert ours.opt_state.step == int(theirs.opt_state.step) == 3
    want_m = params_from_jax(_np_tree(theirs.opt_state.m), cfg)
    top = max(float(t.abs().max()) for t in want_m.values())
    noise = {k for k, t in want_m.items()
             if float(t.abs().max()) <= NOISE_SHARE * top
             and float(ours.opt_state.m[k].abs().max()) <= NOISE_SHARE * top}
    assert noise <= {k for k in sd if k.endswith(("x_bk", "x_bv")) or (
        k.startswith("enc_layers.") and k.endswith(".bk"))}, noise
    for name, mine, theirs_tree in (
            ("params", ours.params, theirs.params),
            ("m", ours.opt_state.m, theirs.opt_state.m),
            ("v", ours.opt_state.v, theirs.opt_state.v)):
        want = params_from_jax(_np_tree(theirs_tree), cfg)
        assert set(mine) == set(want)
        for k, t in mine.items():
            got = t.detach().numpy()
            if k in noise:
                if name == "params":
                    for x in (got, want[k].numpy()):
                        assert np.abs(x).max() <= 3 * 3e-4, (arch, k)
                continue
            zero = name == "params" and not bool(sd[k].any())
            _rel_close(got, want[k].numpy(), f"{arch} {name} {k}",
                       ZERO_INIT_TOL if zero else 1e-5)


@pytest.mark.parametrize("arch", FAMILIES)
def test_microbatches_two_match_one(arch):
    """``microbatches=2`` splits the tokens, the labels and the extras
    alike: one step's parameters equal ``microbatches=1``'s to f32
    rounding (no clipping).  The smoke MoE configs' capacity factor 8
    drops nothing at either batch, so the routing is the same."""
    out = []
    for M in (1, 2):
        tr = _port_trainer(arch, TrainLoopConfig(
            steps=1, microbatches=M, peak_lr=1e-3, clip_norm=None))
        tr.train_one(_batch(tr.cfg, 5), 0)
        out.append({k: p.detach().clone() for k, p in tr.params.items()})
    for k in out[0]:
        np.testing.assert_allclose(out[1][k].numpy(), out[0][k].numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)


def test_extras_reach_the_loss_on_the_trainers_device():
    """A batch's extra arrays arrive at ``model.loss`` as keyword tensors on
    the trainer's device, tokens and labels as int64; tensors are taken as
    they are."""
    tr = _port_trainer("phi-3-vision-4.2b", TrainLoopConfig(steps=1))
    seen = {}
    loss = tr.model.loss

    def spy(tokens, labels, **extras):
        seen.update(tokens=tokens, labels=labels, **extras)
        return loss(tokens, labels, **extras)

    tr.model.loss = spy
    batch = _batch(tr.cfg, 0)
    batch["img_embeds"] = torch.from_numpy(batch["img_embeds"])
    tr.train_one(batch, 0)
    assert set(seen) == {"tokens", "labels", "img_embeds"}
    assert seen["tokens"].dtype == seen["labels"].dtype == torch.int64
    assert seen["img_embeds"].device.type == "cpu"
    assert torch.equal(seen["img_embeds"], batch["img_embeds"])
