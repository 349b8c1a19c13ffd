"""whisper-medium (the encoder-decoder) in the port against the JAX
reference on the CPU.

``whisper-medium-smoke`` (2 encoder and 2 decoder layers, d_model 64, 4
heads of 16, 24 frames, GELU, QKV bias, tied embeddings) with the
reference's own float32 weights (``EncDecLM.init``, seed 0) carried
across by :func:`repro_torch.convert.params_from_jax`: the configs and
parameter counts, ``sinusoidal_positions``, ``encode`` within 1e-5, the
forward within 1e-4, prefill and every decode step on the inputs of
``tests/test_models.py::test_prefill_decode_consistency`` within 1e-4,
the loss within 1e-5 and every gradient within 1e-5 of its largest
element (``x_bk`` / ``x_bv``, never read, exactly zero in both), the
serve cache's entries, and the engine's greedy tokens with ``frames=``
against the reference engine's.  Every kernel runs its plain version
here (CPU tensors).  ``tests/test_torch_vlm.py`` uses the helpers for
phi-3-vision and the two dense configs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro.models.encdec import sinusoidal_positions as jax_sinusoidal
from repro.serving import Request as JaxRequest
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import flash_attention
from repro_torch.launch import serve as launch_serve
from repro_torch.models import EncDecLM, build_model
from repro_torch.models.encdec import sinusoidal_positions
from repro_torch.serving import Request, ServeEngine

ARCH = "whisper-medium"
ATOL = 1e-4
#: the reference test's key and shapes (tests/test_models.py)
KEY = jax.random.PRNGKey(0)
B, S, P, CACHE = 2, 24, 20, 48
_CACHE = {}


def pair(arch):
    """(reference cfg, model, params, port cfg, model, state dict) for the
    smoke config of ``arch``, the weights the reference's ``init`` draws
    from seed 0 in float32."""
    if arch not in _CACHE:
        jcfg = jax_smoke_config(arch)
        jm = jax_build_model(jcfg)
        params = jm.init(KEY, jnp.float32)
        cfg = get_smoke_config(arch)
        sd = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                             cfg)
        model = build_model(cfg, device="cpu")
        model.load_state_dict(sd)
        _CACHE[arch] = (jcfg, jm, params, cfg, model, sd)
    return _CACHE[arch]


def batch(cfg, b=B, s=S):
    """The reference test's batch (``tests/test_models.py::_batch``) as
    NumPy: tokens and labels, and frames or image embeddings by family."""
    out = {"tokens": jax.random.randint(KEY, (b, s), 0, cfg.vocab),
           "labels": jax.random.randint(KEY, (b, s), 0, cfg.vocab)}
    if cfg.family == "encdec":
        out["frames"] = jax.random.normal(
            KEY, (b, cfg.enc_frames, cfg.d_model), jnp.float32)
    if cfg.family == "vlm":
        out["img_embeds"] = jax.random.normal(
            KEY, (b, cfg.img_tokens, cfg.d_model), jnp.float32)
    return {k: np.array(v) for k, v in out.items()}


def extras(bt):
    """The batch's model extras (frames / img_embeds) for each package."""
    keys = [k for k in ("frames", "img_embeds") if k in bt]
    return ({k: jnp.asarray(bt[k]) for k in keys},
            {k: torch.from_numpy(bt[k]) for k in keys})


def tokens(a):
    return torch.from_numpy(np.asarray(a)).long()


def check_configs(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jax_config(arch))
    assert dataclasses.asdict(get_smoke_config(arch)) == \
        dataclasses.asdict(jax_smoke_config(arch))
    for full in (get_config, get_smoke_config):
        ref = jax_config if full is get_config else jax_smoke_config
        assert full(arch).param_count() == ref(arch).param_count()


def check_state_dict(arch):
    """The port's parameters, one for one, are the reference's leaves and
    have their element count."""
    _jcfg, _jm, params, cfg, model, sd = pair(arch)
    assert set(sd) == set(model.state_dict())
    n_ref = sum(int(np.prod(a.shape))
                for a in jax.tree_util.tree_leaves(params))
    assert sum(t.numel() for t in model.state_dict().values()) == n_ref


def check_forward(arch):
    _jcfg, jm, params, cfg, model, _sd = pair(arch)
    bt = batch(cfg)
    jx, tx = extras(bt)
    want, jprefix = jm.forward(params, jnp.asarray(bt["tokens"]), **jx)
    got, prefix = model.forward(tokens(bt["tokens"]), **tx)
    assert prefix == jprefix
    assert got.shape == want.shape == (B, S + prefix, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    return prefix


def check_prefill_decode(arch):
    """Prefill ``P`` tokens, then decode the batch's next ``S - P`` tokens
    in both packages: every step's logits within 1e-4 of the reference's
    and of the reference's full forward; the next position counts the
    prefix.  Returns that position."""
    _jcfg, jm, params, cfg, model, _sd = pair(arch)
    bt = batch(cfg)
    jx, tx = extras(bt)
    toks = bt["tokens"]
    full, prefix = jm.forward(params, jnp.asarray(toks), **jx)
    full = np.asarray(full)
    jc, jl, jpos = jm.prefill(params, jnp.asarray(toks[:, :P]), CACHE, **jx)
    tc, tl, tpos = model.prefill(tokens(toks[:, :P]), CACHE, **tx)
    assert tpos == jpos == P + prefix
    for j in range(S - P + 1):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(tl.numpy(), full[:, prefix + P - 1 + j],
                                   atol=ATOL, rtol=0)
        if j == S - P:
            break
        t = toks[:, P + j:P + j + 1]
        jl, jc = jm.decode_step(params, jc, jnp.asarray(t), jpos + j, CACHE)
        tl, tc = model.decode_step(tc, tokens(t), tpos + j, CACHE)
    return tpos


def check_loss_and_grads(arch, zero=(), flat=()):
    """The loss within 1e-5 and each gradient within 1e-5 of its largest
    element against ``jax.value_and_grad``; the gradients named in
    ``zero`` exactly zero in both packages.  Those named in ``flat`` are
    zero in exact arithmetic but not in rounding (a key bias of a layer
    without rope adds one constant to a query's every score, which the
    softmax does not see): both packages' are held under 1e-6 of the
    largest gradient element of the model, where they have no element of
    their own to be measured against."""
    _jcfg, jm, params, cfg, _model, sd = pair(arch)
    bt = batch(cfg)
    jx, tx = extras(bt)
    jb = {"tokens": jnp.asarray(bt["tokens"]),
          "labels": jnp.asarray(bt["labels"]), **jx}
    want_loss, jgrads = jax.value_and_grad(jm.loss)(params, jb)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), cfg)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(sd)
    model.requires_grad_(True)
    loss = model.loss(tokens(bt["tokens"]), tokens(bt["labels"]), **tx)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               atol=1e-5, rtol=0)
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    top = max(float(w.abs().max()) for w in want.values())
    for name, prm in named.items():
        g = (torch.zeros_like(prm) if prm.grad is None else prm.grad).numpy()
        w = want[name].numpy()
        if name.rsplit(".", 1)[-1] in zero:
            assert not w.any() and not g.any(), name
            continue
        if any(name.startswith(f) for f in flat):
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-6 * top, name
            continue
        err = float(np.abs(g - w).max())
        assert err <= 1e-5 * float(np.abs(w).max()), (name, err)


def check_init_cache(arch, extra_keys=()):
    """One cache dict a layer whose entries are the reference's grouped
    ``<name>@0`` leaves, unstacked."""
    _jcfg, jm, _params, cfg, model, _sd = pair(arch)
    cache = model.init_cache(3, 32, dtype=torch.bfloat16)
    ref = jm.init_cache(3, 32, jnp.bfloat16)["blocks"]
    assert len(cache) == cfg.n_layers
    want = {name.split("@")[0]: a.shape for name, a in ref.items()}
    for layer in cache:
        assert {k: tuple(v.shape) for k, v in layer.items()} == \
            {k: tuple(s[2:]) for k, s in want.items()}
        assert all(t.dtype == torch.bfloat16 and not t.any()
                   for t in layer.values())
    assert all(s[:2] == (cfg.n_layers, 1) for s in want.values())
    assert set(extra_keys) <= set(cache[0])


def _requests(cls, vocab, lengths, new):
    rng = np.random.default_rng(3)
    return [cls(i, rng.integers(0, vocab, n).astype(np.int32),
                max_new_tokens=m) for i, (n, m) in enumerate(zip(lengths,
                                                                   new))]


def check_engine(arch):
    """Left-padded waves of 2 through both engines with the model's
    extras of batch 2: the same greedy tokens."""
    jcfg, _jm, params, cfg, _model, sd = pair(arch)
    jx, tx = extras(batch(cfg, b=2))
    lengths, new = (12, 20, 9, 17), (4, 6, 5, 6)
    jeng = JaxServeEngine(jcfg, batch=2, cache_len=64, params=params)
    teng = ServeEngine(cfg, batch=2, cache_len=64, params=sd, device="cpu")
    jdone = jeng.serve_queue(_requests(JaxRequest, cfg.vocab, lengths, new),
                             **jx)
    tdone = teng.serve_queue(_requests(Request, cfg.vocab, lengths, new),
                             **tx)
    assert [r.out_tokens for r in tdone] == [r.out_tokens for r in jdone]
    assert [len(r.out_tokens) for r in tdone] == list(new)


def check_launcher(arch):
    """``launch.serve.serve`` with ``extras`` on the CPU: no launch, every
    request its tokens in the vocabulary."""
    cfg = get_smoke_config(arch)
    _jx, tx = extras(batch(cfg, b=2))
    before = flash_attention.LAUNCHES
    run = launch_serve.serve(arch, smoke=True, requests=4, batch=2,
                             prompt_len=16, new_tokens=3, cache_len=64,
                             device="cpu", extras=tx)
    assert flash_attention.LAUNCHES == before
    assert run.summary["generated_tokens"] == 12
    assert all(0 <= t < cfg.vocab for r in run.done for t in r.out_tokens)


# ---------------------------------------------------------------------------


def test_configs_match_reference():
    check_configs(ARCH)


def test_build_model_is_the_encoder_decoder():
    _jcfg, _jm, _params, cfg, model, _sd = pair(ARCH)
    assert isinstance(model, EncDecLM)
    assert len(model.enc_layers) == cfg.enc_layers
    assert all(not b.spec.causal and not b.spec.cross
               for b in model.enc_layers)
    assert all(b.spec.cross and b.spec.causal for b in model.layers)
    assert "w_gate" not in model.layers[0].defs        # GELU: no gate


def test_params_from_jax_unstacks_encoder_and_decoder():
    check_state_dict(ARCH)
    _jcfg, _jm, params, cfg, _model, sd = pair(ARCH)
    for name in ("frontend", "enc_ln"):
        assert np.array_equal(sd[name], np.asarray(params[name]))
    for name, arr in params["enc_blocks"].items():
        for i in range(cfg.enc_layers):
            assert np.array_equal(sd[f"enc_layers.{i}.{name}"],
                                  np.asarray(arr[i]))
    for name, arr in params["blocks"].items():
        for i in range(cfg.n_layers):
            assert np.array_equal(sd[f"layers.{i}.{name}"],
                                  np.asarray(arr[i]))
    assert {"layers.0.x_wq", "layers.0.x_bk", "layers.0.x_k_cache"} & \
        set(sd) == {"layers.0.x_wq", "layers.0.x_bk"}


@pytest.mark.parametrize("S_,d", [(24, 64), (1500, 1024), (7, 6)])
def test_sinusoidal_positions_equal(S_, d):
    got = sinusoidal_positions(S_, d)
    assert got.dtype == np.float32 and got.shape == (S_, d)
    assert np.array_equal(got, jax_sinusoidal(S_, d))


def test_encode_matches():
    _jcfg, jm, params, cfg, model, _sd = pair(ARCH)
    frames = batch(cfg)["frames"].copy()
    want = np.asarray(jm.encode(params, jnp.asarray(frames)))
    got = model.encode(torch.from_numpy(frames))
    assert got.shape == (B, cfg.enc_frames, cfg.d_model)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5,
                               rtol=0)


def test_forward_logits_match():
    assert check_forward(ARCH) == 0


def test_prefill_and_every_decode_step_match():
    assert check_prefill_decode(ARCH) == P


def test_loss_and_every_gradient_match_jax():
    cfg = get_smoke_config(ARCH)
    check_loss_and_grads(ARCH, zero=("x_bk", "x_bv"), flat=[
        f"enc_layers.{i}.bk" for i in range(cfg.enc_layers)])


def test_init_cache_matches_reference():
    check_init_cache(ARCH, extra_keys=("x_k_cache", "x_v_cache"))


def test_cross_cache_passes_through_decode():
    """The cross K / V of prefill are the ones every decode step reads and
    returns: the same tensors."""
    _jcfg, _jm, _params, cfg, model, _sd = pair(ARCH)
    bt = batch(cfg)
    _jx, tx = extras(bt)
    cache, _lg, pos = model.prefill(tokens(bt["tokens"][:, :P]), CACHE, **tx)
    xk = [c["x_k_cache"] for c in cache]
    _lg, cache2 = model.decode_step(cache, tokens(bt["tokens"][:, P:P + 1]),
                                    pos, CACHE)
    assert all(a is c["x_k_cache"] for a, c in zip(xk, cache2))
    assert xk[0].shape == (B, cfg.enc_frames, cfg.n_kv_heads, cfg.hd)


def test_every_entry_point_needs_frames():
    _jcfg, _jm, _params, cfg, model, _sd = pair(ARCH)
    t = tokens(batch(cfg)["tokens"])
    for call in (lambda: model.forward(t), lambda: model.prefill(t, CACHE),
                 lambda: model.loss(t, t)):
        with pytest.raises(ValueError, match="frames"):
            call()


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_cross_layer_needs_the_encoder_output(mode):
    """A decoder layer called without ``enc_out`` outside decode raises:
    it never falls back to self-attention's weights or cache."""
    from repro_torch.models.blocks import layer_apply
    _jcfg, _jm, _params, cfg, model, _sd = pair(ARCH)
    blk = model.layers[0]
    x = torch.zeros(B, 4, cfg.d_model)
    with pytest.raises(ValueError, match="enc_out"):
        layer_apply(dict(blk._parameters), x, cfg, blk.spec, mode=mode,
                    cache={} if mode == "prefill" else None, cache_len=CACHE)


def test_serve_queue_with_frames_matches_reference_engine():
    check_engine(ARCH)


def test_launcher_serves_with_extras_on_the_cpu():
    check_launcher(ARCH)
