"""The port's LM serving path against the JAX reference on the CPU.

``qwen2-moe-smoke`` (2 layers, 8 experts top-2, 2 shared experts, QKV
bias) with the reference's own float32 weights (``LM.init``, seed 0)
carried across by :func:`repro_torch.convert.params_from_jax`: the full
forward, prefill and four decode steps agree within atol 1e-4 (f32
matmuls summed in another order); ``ServeEngine`` serves the same
left-padded requests to the same greedy tokens as the reference's engine
and as the repeated-forward oracle of ``tests/test_runtime.py``; and the
tracer's spans give the same ``flat_profile`` names and call counts.
Every kernel runs its plain version here (CPU tensors).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro.runtime import Tracer as JaxTracer
from repro.serving import Request as JaxRequest
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import flash_attention, topk_gating
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.runtime import Tracer
from repro_torch.serving import Request, ServeEngine

ARCH = "qwen2-moe-a2.7b"
ATOL = 1e-4


@pytest.fixture(scope="module")
def ref():
    cfg = jax_smoke_config(ARCH)
    model = jax_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.float32)
    return cfg, model, params


@pytest.fixture(scope="module")
def port(ref):
    cfg = get_smoke_config(ARCH)
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, ref[2]), cfg)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(sd)
    return cfg, model, sd


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _requests(cls, vocab):
    rng = np.random.default_rng(3)
    lengths, new = (5, 12, 9, 16), (4, 6, 5, 6)
    return [cls(i, rng.integers(0, vocab, n).astype(np.int32),
                max_new_tokens=m) for i, (n, m) in enumerate(zip(lengths,
                                                                   new))]


def test_configs_match_reference():
    assert dataclasses.asdict(get_smoke_config(ARCH)) == \
        dataclasses.asdict(jax_smoke_config(ARCH))
    from repro.configs import get_config as jax_config
    full = get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(jax_config(ARCH))
    assert full.param_count() == jax_config(ARCH).param_count()
    assert (full.padded_vocab, full.hd) == (152064, 128)


def test_params_from_jax_unstacks_every_leaf(ref, port):
    cfg, model, sd = port
    assert set(sd) == set(model.state_dict())
    blocks = ref[2]["blocks"]
    for name, arr in blocks.items():
        for i in range(cfg.n_layers):
            assert np.array_equal(sd[f"layers.{i}.{name}"].numpy(),
                                  np.asarray(arr[i]))
    assert np.array_equal(sd["unembed"].numpy(), np.asarray(ref[2]["unembed"]))


def test_params_from_jax_keeps_bfloat16_bits(ref, port):
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.bfloat16)), ref[2])
    sd = params_from_jax(tree, port[0])
    assert sd["embed"].dtype == torch.bfloat16
    want = np.asarray(ref[2]["embed"].astype(jnp.bfloat16).astype(
        jnp.float32))
    assert np.array_equal(sd["embed"].float().numpy(), want)


@pytest.mark.parametrize("S", [1, 12, 33])
def test_forward_logits_match(ref, port, S):
    toks = _tokens(S, 2, S, ref[0].vocab)
    want, _ = ref[1].forward(ref[2], jnp.asarray(toks))
    got, prefix = port[1].forward(torch.from_numpy(toks).long())
    assert prefix == 0 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("S,cache_len", [(12, 32), (20, 20)])
def test_prefill_and_decode_logits_match(ref, port, S, cache_len):
    cfg, jm, params = ref
    tm = port[1]
    toks = _tokens(7, 2, S, cfg.vocab)
    jc, jl, jpos = jm.prefill(params, jnp.asarray(toks), cache_len)
    tc, tl, tpos = tm.prefill(torch.from_numpy(toks).long(), cache_len)
    assert jpos == tpos == S
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    tok = np.argmax(np.asarray(jl)[:, :cfg.vocab], -1)
    for step in range(4):
        jl, jc = jm.decode_step(params, jc, jnp.asarray(tok[:, None]),
                                jpos + step, cache_len)
        tl, tc = tm.decode_step(tc, torch.from_numpy(tok[:, None]).long(),
                                tpos + step, cache_len)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        tok = np.argmax(np.asarray(jl)[:, :cfg.vocab], -1)


def test_decode_from_a_zeroed_cache_matches(ref, port):
    cfg, jm, params = ref
    cache = port[1].init_cache(3, 16)
    assert len(cache) == cfg.n_layers
    assert cache[0]["k_cache"].shape == (3, 16, cfg.n_kv_heads, cfg.hd)
    jc = jm.init_cache(3, 16, jnp.float32)
    tok = _tokens(11, 3, 1, cfg.vocab)
    for pos in range(3):
        jl, jc = jm.decode_step(params, jc, jnp.asarray(tok), pos, 16)
        tl, cache = port[1].decode_step(cache, torch.from_numpy(tok).long(),
                                        pos, 16)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        tok = np.argmax(np.asarray(jl)[:, :cfg.vocab], -1)[:, None].astype(
            np.int32)


def test_serve_queue_matches_reference_engine(ref, port):
    cfg, _, params = ref
    jt, tt = JaxTracer(), Tracer()
    jeng = JaxServeEngine(cfg, batch=2, cache_len=64, params=params,
                          tracer=jt)
    teng = ServeEngine(port[0], batch=2, cache_len=64, params=port[2],
                       tracer=tt, device="cpu")
    jdone = jeng.serve_queue(_requests(JaxRequest, cfg.vocab))
    tdone = teng.serve_queue(_requests(Request, cfg.vocab))
    assert [r.out_tokens for r in tdone] == [r.out_tokens for r in jdone]
    assert [len(r.out_tokens) for r in tdone] == [4, 6, 5, 6]
    # the same spans: names and call counts of the two tracers' profiles
    jp = jt.to_trace().flat_profile()
    tp = tt.to_trace(device="cpu").flat_profile()
    assert dict(zip(tp["Name"], tp["count"])) == \
        dict(zip(jp["Name"], jp["count"]))
    assert set(tp["Name"]) == {"wave", "prefill", "decode", "decode_step"}


def test_greedy_matches_repeated_forward(port):
    cfg, model, sd = port
    eng = ServeEngine(cfg, batch=2, cache_len=64, params=sd, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, 12).astype(np.int32)
               for _ in range(2)]
    done = eng.generate([Request(i, p, max_new_tokens=4)
                         for i, p in enumerate(prompts)])
    for r, prompt in zip(done, prompts):
        toks = list(prompt)
        for j in range(4):
            logits, _ = model.forward(torch.tensor([toks]))
            nxt = int(torch.argmax(logits[0, -1, :cfg.vocab]))
            assert nxt == r.out_tokens[j], (r.rid, j)
            toks.append(nxt)


def test_launcher_serves_on_the_cpu_without_launches():
    before = (flash_attention.LAUNCHES, topk_gating.LAUNCHES)
    run = launch_serve.serve(ARCH, smoke=True, requests=3, batch=2,
                             prompt_len=10, new_tokens=3, cache_len=32,
                             device="cpu")
    # CPU tensors run the plain versions: no launch is counted
    assert (flash_attention.LAUNCHES, topk_gating.LAUNCHES) == before
    assert run.summary["requests"] == 3
    assert run.summary["generated_tokens"] == 9
    vocab = run.engine.cfg.vocab
    assert all(0 <= t < vocab for r in run.done for t in r.out_tokens)
    names = set(run.tracer.to_trace(device="cpu").flat_profile()["Name"])
    assert names == {"init", "wave", "prefill", "decode", "decode_step"}


def test_launcher_requests_follow_the_reference_draws():
    reqs = launch_serve.make_requests(512, 8, 32, 16)
    rng = np.random.default_rng(0)
    for r in reqs:
        want = rng.integers(0, 512, rng.integers(4, 33), dtype=np.int32)
        assert np.array_equal(r.prompt, want)
        assert r.max_new_tokens == 16


def test_sampling_with_temperature_is_seeded(port):
    cfg, _, sd = port
    outs = []
    for _ in range(2):
        eng = ServeEngine(cfg, batch=2, cache_len=32, params=sd,
                          temperature=0.8, seed=5, device="cpu")
        outs.append([r.out_tokens for r in eng.generate(
            _requests(Request, cfg.vocab)[:2])])
    assert outs[0] == outs[1]
    assert all(0 <= t < cfg.vocab for row in outs[0] for t in row)


def test_init_draws_from_the_generator(port):
    cfg = port[0]
    a = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    b = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    for (name, x), (_, y) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        assert torch.equal(x, y), name
    wq = a.state_dict()["layers.0.wq"]
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.1 * \
        cfg.d_model ** -0.5
    assert not a.state_dict()["layers.0.ln"].any()


@pytest.mark.parametrize("name", ["gemma3-27b", "mamba2-130m",
                                  "whisper-medium", "qwen1.5-0.5b"])
def test_unported_architectures_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_config(name)
    with pytest.raises(KeyError):
        get_config("no-such-arch")


@pytest.mark.parametrize("name", ["gemma3-27b", "mamba2-130m",
                                  "hymba-1.5b", "whisper-medium"])
def test_unported_families_raise_in_the_model(name):
    cfg = jax_smoke_config(name)
    port_cfg = type(get_smoke_config(ARCH))(**dataclasses.asdict(cfg))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(port_cfg, device="cpu")


def test_tracer_sink_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Tracer(sink="rank_0.pack")


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")


def test_serving_defaults_to_the_card_and_raises_without_one(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(get_smoke_config(ARCH), batch=1, cache_len=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(get_smoke_config(ARCH))
