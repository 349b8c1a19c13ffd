"""phi-3-vision-4.2b (image tokens), codeqwen1.5-7b and qwen1.5-0.5b in the
port against the JAX reference on the CPU, with the pieces they need:
GELU, the flash kernel's plain version at head dim 96, and the dry-run
stand-ins (``input_specs``).

``phi-3-vision-smoke`` (2 layers, d_model 64, 4 heads of 16, 8 image
tokens) with the reference's own float32 weights carried across by
:func:`repro_torch.convert.params_from_jax`, fed the image embeddings of
``tests/test_models.py``: the forward within 1e-4 with a prefix of 8,
prefill and every decode step within 1e-4 (the next position counts the
8 image tokens), the loss (the prefix dropped) within 1e-5 and every
gradient within 1e-5 of its largest element, the serve cache, and the
engine's greedy tokens with ``img_embeds=`` against the reference
engine's.  The two dense smoke configs (QKV bias; qwen1.5-0.5b's tied
embeddings): configs, ``params_from_jax``, forward, prefill and decode.
Helpers are ``tests/test_torch_encdec.py``'s.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import SHAPES as JAX_SHAPES
from repro.models import input_specs as jax_input_specs
from repro.models.attention import chunked_attention as jax_chunked
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.cardcheck import flash_bwd_tol
from repro_torch.models import SHAPES, build_model, input_specs
from repro_torch.models.layers import gelu
from test_torch_encdec import (batch, check_configs, check_engine,
                               check_forward, check_init_cache,
                               check_launcher, check_loss_and_grads,
                               check_prefill_decode, check_state_dict, pair,
                               tokens, P)

VLM = "phi-3-vision-4.2b"
DENSE = ("codeqwen1.5-7b", "qwen1.5-0.5b")


@pytest.mark.parametrize("arch", (VLM,) + DENSE)
def test_configs_match_reference(arch):
    check_configs(arch)


@pytest.mark.parametrize("arch", (VLM,) + DENSE)
def test_params_from_jax_carries_every_leaf(arch):
    check_state_dict(arch)


def test_full_configs_at_their_published_widths():
    phi = get_config(VLM)
    assert (phi.n_layers, phi.d_model, phi.n_heads, phi.hd,
            phi.img_tokens) == (32, 3072, 32, 96, 144)
    assert fa.variant(torch.bfloat16, phi.hd) == "simt"
    cq = get_config("codeqwen1.5-7b")
    assert (cq.n_layers, cq.d_model, cq.n_heads, cq.n_kv_heads, cq.hd,
            cq.qkv_bias) == (32, 4096, 32, 32, 128, True)
    qw = get_config("qwen1.5-0.5b")
    assert (qw.n_layers, qw.hd, qw.vocab, qw.tie_embeddings) == \
        (24, 64, 151936, True)
    for cfg in (cq, qw):
        assert fa.variant(torch.bfloat16, cfg.hd) == "wgmma"


@pytest.mark.parametrize("arch", (VLM,) + DENSE)
def test_forward_logits_match(arch):
    prefix = check_forward(arch)
    assert prefix == get_smoke_config(arch).img_tokens


@pytest.mark.parametrize("arch", (VLM,) + DENSE)
def test_prefill_and_every_decode_step_match(arch):
    assert check_prefill_decode(arch) == P + get_smoke_config(arch).img_tokens


@pytest.mark.parametrize("arch", (VLM, "qwen1.5-0.5b"))
def test_loss_and_every_gradient_match_jax(arch):
    check_loss_and_grads(arch)


def test_loss_drops_the_image_prefix():
    """The loss is the cross-entropy of the token positions alone: the
    forward's logits from position 8 on."""
    _jcfg, _jm, _params, cfg, model, _sd = pair(VLM)
    bt = batch(cfg)
    img = torch.from_numpy(bt["img_embeds"])
    logits, prefix = model.forward(tokens(bt["tokens"]), img_embeds=img)
    assert prefix == cfg.img_tokens == 8
    want = torch.nn.functional.cross_entropy(
        logits[:, prefix:].reshape(-1, logits.shape[-1]).float(),
        tokens(bt["labels"]).reshape(-1))
    got = model.loss(tokens(bt["tokens"]), tokens(bt["labels"]),
                     img_embeds=img)
    np.testing.assert_allclose(float(got), float(want), atol=1e-5, rtol=0)


def test_image_prefix_is_causal():
    """The image positions attend causally, as the reference's (its
    ``prefix_len`` is the meta tokens', 0 here): the first image position's
    logits do not move when the last image embedding changes."""
    _jcfg, _jm, _params, cfg, model, _sd = pair(VLM)
    bt = batch(cfg)
    img = torch.from_numpy(bt["img_embeds"])
    other = img.clone()
    other[:, -1] += 1.0
    a, _ = model.forward(tokens(bt["tokens"]), img_embeds=img)
    b, _ = model.forward(tokens(bt["tokens"]), img_embeds=other)
    assert torch.equal(a[:, :cfg.img_tokens - 1], b[:, :cfg.img_tokens - 1])
    assert not torch.equal(a[:, cfg.img_tokens:], b[:, cfg.img_tokens:])


@pytest.mark.parametrize("arch", (VLM,) + DENSE)
def test_init_cache_matches_reference(arch):
    check_init_cache(arch)


@pytest.mark.parametrize("arch", (VLM,) + DENSE)
def test_serve_queue_matches_reference_engine(arch):
    check_engine(arch)


def test_launcher_serves_with_image_embeddings_on_the_cpu():
    check_launcher(VLM)


def test_gelu_matches_jax():
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32) * 4
    want = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True))
    got = gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


#: (B, Sq, Sk, H, KVH, kwargs) at D = 96
FLASH_96 = {
    "causal": (2, 40, 40, 4, 4, {}),
    "gqa": (1, 33, 33, 4, 2, {}),
    "cross": (2, 9, 45, 2, 2, {"causal": False}),
    "decode-row": (2, 1, 1100, 2, 2, {"causal": False}),
}


def _flash_inputs(case):
    B, Sq, Sk, H, KVH, kw = FLASH_96[case]
    rng = np.random.default_rng(5)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, 96), (B, Sk, KVH, 96), (B, Sk, KVH, 96),
                      (B, Sq, H, 96))]
    return arrs, kw


@pytest.mark.parametrize("case", list(FLASH_96))
def test_flash_plain_at_head_dim_96_matches_chunked_attention(case):
    arrs, kw = _flash_inputs(case)
    want = np.asarray(jax_chunked(*(jnp.asarray(a) for a in arrs[:3]), **kw))
    got = fa.flash_attention(*(torch.from_numpy(a) for a in arrs[:3]), **kw)
    assert got.shape == arrs[0].shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("case", list(FLASH_96))
def test_flash_bwd_plain_at_head_dim_96_matches_jax_grad(case):
    arrs, kw = _flash_inputs(case)
    q, k, v, do = (jnp.asarray(a) for a in arrs)

    def f(q, k, v):
        return jnp.sum(jax_chunked(q, k, v, **kw) * do)

    want = jax.grad(f, (0, 1, 2))(q, k, v)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in arrs)
    o, lse = fa.flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    got = fa.flash_attention_bwd_plain(tq, tk, tv, o, tdo, lse, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= flash_bwd_tol(torch.float32, w), (name, err)


@pytest.mark.parametrize("arch", ["whisper-medium", VLM, "qwen1.5-0.5b"])
@pytest.mark.parametrize("shape", list(JAX_SHAPES))
def test_input_specs_match_reference(arch, shape):
    """The dry run's stand-ins: the reference's names, shapes and dtypes,
    on the ``meta`` device (no storage)."""
    cfg = get_config(arch)
    assert dataclasses.asdict(SHAPES[shape]) == \
        dataclasses.asdict(JAX_SHAPES[shape])
    want = jax_input_specs(jax_smoke_config(arch).__class__(
        **dataclasses.asdict(cfg)), JAX_SHAPES[shape])
    got = input_specs(cfg, SHAPES[shape])
    assert set(got) == set(want)
    for name, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[name].shape), name
        assert str(t.dtype).replace("torch.", "") == str(want[name].dtype)


def test_dense_model_with_gelu_and_image_rows_builds_on_the_cpu():
    """A dense layer with ``act="gelu"`` has no ``w_gate``; a dense config
    given image embeddings takes them as a causal prefix."""
    cfg = dataclasses.replace(get_smoke_config("qwen1.5-0.5b"), act="gelu")
    model = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    assert "w_gate" not in dict(model.layers[0].named_parameters())
    img = torch.randn(2, 3, cfg.d_model, generator=torch.Generator()
                      .manual_seed(1))
    logits, prefix = model.forward(torch.zeros(2, 5, dtype=torch.long),
                                   img_embeds=img)
    assert prefix == 3 and logits.shape == (2, 8, cfg.padded_vocab)
