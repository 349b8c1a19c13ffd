"""The port's logical-axis sharding (``repro_torch.distributed.sharding``)
against the reference's rules, and its sharded model on gloo meshes.

* ``rules_for`` and ``logical_to_spec`` equal the reference's for all
  eleven configs, on the reference tests' stand-in meshes (16 x 16,
  2 x 16 x 16 and 2 x 4) with ``long_context`` both ways: every
  parameter's and every cache entry's spec.  The port declares each
  layer's parameters unstacked, so the reference's leading stacked axes
  (``layers``, ``layers_inner``, which map to no mesh axis) are dropped
  from its specs before comparing.
* On real gloo process groups (subprocesses from a script on disk, a
  ``FileStore`` under the test's directory): the smoke qwen1.5-0.5b loss
  on a (2, 2) mesh equals the single-process loss within 1e-5 and the
  reference's ``model.loss`` on the same weights within 1e-4, every
  gradient within 1e-5 of its largest magnitude, a cell's train step
  runs and its parameters equal a single-process AdamW step on the same
  weights, gradients and rate within 1e-5 of each leaf's largest value
  plus 1e-4 of the step size (``update_err``); greedy tokens through the
  prefill and decode cells (``CellEngine``) equal the single-process
  engine's.  The smoke qwen3-moe runs on (1, 4) with its
  experts sharded on ``model``, the smoke gemma3 on (1, 4) with K / V
  broadcast to the query heads (``attn_broadcast_kv``) and the smoke
  qwen2-moe on (2, 2) with two token groups on ``data``, each on the
  reference's weights and within the same tolerances, and the smoke
  mamba2 on (2, 2) and hymba on (1, 4) (the SSD's heads on ``model``).
* The experimental int8 cross-pod cell on (pod 2, data 1, model 2): the
  means it applies are the full batch's gradient within the int8 error
  bound, and its step is a single-process AdamW step on those means.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ARCH_NAMES as JAX_ARCH_NAMES
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.distributed.sharding import DEFAULT_RULES as JAX_DEFAULT_RULES
from repro.distributed.sharding import batch_spec as jax_batch_spec
from repro.distributed.sharding import logical_to_spec as jax_l2s
from repro.distributed.sharding import rules_for as jax_rules_for
from repro.models import build_model as jax_build_model
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.distributed import sharding
from repro_torch.models import build_model

ROOT = Path(__file__).resolve().parent.parent


class FakeMesh:
    """The reference tests' stand-in: only ``shape`` is read."""

    def __init__(self, shape):
        self.shape = shape


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x4": {"data": 2, "model": 4}}
CASES = [(a, m, lc) for a in ARCH_NAMES for m in MESHES for lc in (False,
                                                                   True)]
_STACKED = ("layers", "layers_inner")


def _norm(rules):
    return {k: (tuple(v) if isinstance(v, (list, tuple)) else v)
            for k, v in rules.as_dict().items()}


def _unstacked(d, spec):
    """The reference's spec of a stacked def without its stacked axes."""
    n = 0
    while n < len(d.axes) and d.axes[n] in _STACKED:
        n += 1
    out = list(tuple(spec))[n:]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _jax_layer_defs(tree, prefix):
    """{leaf name: stacked ParamDef} of the reference's stacked layer
    groups under ``prefix`` keys."""
    out = {}
    for key in prefix:
        for name, d in (tree.get(key) or {}).items():
            out.setdefault(name, d)
    return out


def _port_model(cfg):
    with FakeTensorMode():          # shapes only: no storage
        return build_model(cfg, device="cpu")


def test_arch_names_and_param_counts_equal_the_reference():
    assert ARCH_NAMES == list(JAX_ARCH_NAMES)
    for name in ARCH_NAMES:
        ours, ref = get_config(name), jax_config(name)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref), name
        assert ours.param_count() == ref.param_count(), name
        assert ours.active_param_count() == ref.active_param_count(), name
        assert dataclasses.asdict(get_smoke_config(name)) == \
            dataclasses.asdict(jax_smoke_config(name)), name


def test_default_rules_equal_the_reference():
    assert _norm(sharding.DEFAULT_RULES) == _norm(JAX_DEFAULT_RULES)


@pytest.mark.parametrize("arch,mesh,long_context", CASES)
def test_rules_for_equals_the_reference(arch, mesh, long_context):
    m = FakeMesh(MESHES[mesh])
    ours = sharding.rules_for(get_config(arch), m, long_context=long_context)
    ref = jax_rules_for(jax_config(arch), m, long_context=long_context)
    assert _norm(ours) == _norm(ref)


@pytest.mark.parametrize("arch,mesh,long_context", CASES)
def test_param_and_cache_specs_equal_the_reference(arch, mesh, long_context):
    m = FakeMesh(MESHES[mesh])
    cfg, jcfg = get_config(arch), jax_config(arch)
    rules = sharding.rules_for(cfg, m, long_context=long_context)
    jrules = jax_rules_for(jcfg, m, long_context=long_context)
    model, jmodel = _port_model(cfg), jax_build_model(jcfg)
    jdefs = jmodel.param_defs()
    dec = _jax_layer_defs(jdefs, ("blocks", "tail"))
    enc = _jax_layer_defs(jdefs, ("enc_blocks",))
    n = 0
    for name, d in model.param_defs().items():
        parts = name.split(".")
        if parts[0] in ("layers", "enc_layers"):
            jd = (enc if parts[0] == "enc_layers" else dec)[parts[-1]]
        else:
            jd = jdefs[name]
        want = _unstacked(jd, jax_l2s(jd.axes, jrules, m, jd.shape))
        got = sharding.logical_to_spec(d.axes, rules, m, d.shape)
        assert got == want, (name, got, want)
        n += 1
    assert n == len(list(model.parameters()))
    # the serve cache: batch 128 over 32k positions (decode_32k's cell)
    jcache = jmodel.cache_defs(128, 32_768)
    jc = [(k.split("@")[0], d) for key in ("blocks", "tail")
          for k, d in (jcache.get(key) or {}).items()]
    for layer in model.cache_defs(128, 32_768):
        for name, d in layer.items():
            jd, = [j for k, j in jc if k == name and
                   j.shape[len(j.shape) - len(d.shape):] == d.shape][:1]
            want = _unstacked(jd, jax_l2s(jd.axes, jrules, m, jd.shape))
            assert sharding.logical_to_spec(d.axes, rules, m, d.shape) \
                == want, name


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_logical_to_spec_and_batch_spec_equal_the_reference(mesh):
    """Every pair of logical axes on dimensions of several sizes (the
    divisibility and no-reuse rules), and ``batch_spec`` at several
    batches."""
    m = FakeMesh(MESHES[mesh])
    names = [k for k, _v in sharding.DEFAULT_RULES.rules] + [None, "nope"]
    for a in names:
        for b in names:
            for shape in ((1024, 1024), (60, 2048), (25, 48), (32, 7)):
                got = sharding.logical_to_spec((a, b), sharding.DEFAULT_RULES,
                                               m, shape)
                want = tuple(jax_l2s((a, b), JAX_DEFAULT_RULES, m, shape))
                assert got == want, (a, b, shape)
    for batch in (1, 2, 3, 8, 16, 32, 128, 256, 512, 1000):
        assert sharding.batch_spec(m, batch) == \
            tuple(jax_batch_spec(m, batch)), batch


def test_constrain_is_a_no_op_outside_a_context():
    x = torch.randn(4, 8)
    assert sharding.constrain(x, "act_batch", "act_embed") is x
    assert sharding.active() is None


# ---------------------------------------------------------------------------
# gloo meshes, in subprocesses
# ---------------------------------------------------------------------------

GLOO = textwrap.dedent('''
    import json, os, sys
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp


    def run(rank, world, work):
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(work, "store"), world),
            rank=rank, world_size=world)
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.configs import get_smoke_config
        from repro_torch.distributed.sharding import activation_sharding
        from repro_torch.launch.steps import CellEngine, build_cell
        from repro_torch.models import build_model
        from repro_torch.models.config import ShapeConfig
        from repro_torch.optim import adamw_init, adamw_update
        from repro_torch.serving import Request, ServeEngine
        LR = 1e-3
        blob = torch.load(os.path.join(work, "inputs.pt"))
        cfg = get_smoke_config(blob["arch"])
        mesh = init_device_mesh("cpu", tuple(blob["mesh"]),
                                mesh_dim_names=("data", "model"))
        model = build_model(cfg, device="cpu")
        model.load_state_dict(blob["state"])
        model.requires_grad_(True)
        tokens, labels = blob["tokens"], blob["labels"]
        loss1 = model.loss(tokens, labels)
        names = [k for k, _ in model.named_parameters()]
        g1 = torch.autograd.grad(loss1, list(model.parameters()),
                                 allow_unused=True, materialize_grads=True)
        B, S = tokens.shape
        cell = build_cell(cfg, ShapeConfig("t", S, B, "train"), mesh,
                          dtype=torch.float32, model=model,
                          lr_schedule=lambda step: LR)
        params, opt, batch = cell.make_args({"tokens": tokens,
                                             "labels": labels})
        local = {k: list(p.to_local().shape) for k, p in params.items()}
        with activation_sharding(mesh, cell.rules):
            loss = model.loss(batch["tokens"], batch["labels"])
            g = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True, materialize_grads=True)
        rel = max(float((a.full_tensor() - b).abs().max())
                  / max(float(b.abs().max()), 1e-30)
                  for a, b in zip(g, g1))
        # one single-process AdamW step on the same weights, the same
        # (sharded) gradients gathered whole, and the same rate
        ref = {k: blob["state"][k].clone().float() for k in params}
        adamw_update(ref, {k: a.full_tensor().clone()
                           for k, a in zip(params, g)}, adamw_init(ref), LR)
        params, opt, step_loss = cell.fn(params, opt, batch)
        full = {k: p.detach().full_tensor() for k, p in params.items()}
        finite = all(bool(torch.isfinite(p).all()) for p in full.values())
        moved = max(float((full[k] - blob["state"][k]).abs().max())
                    for k in ref)
        out = {"single": float(loss1), "sharded": float(loss.full_tensor()),
               "step_loss": float(step_loss.full_tensor()),
               "grad_rel": rel, "finite": finite, "local": local,
               "moved": moved,
               "rules": {k: v for k, v in cell.rules.rules}}
        if blob.get("greedy"):
            eng = ServeEngine(cfg, batch=B, cache_len=2 * S,
                              params=blob["state"], device="cpu")
            reqs = [Request(i, tokens[i].numpy(), max_new_tokens=6)
                    for i in range(B)]
            want = [r.out_tokens for r in eng.generate(reqs)]
            m2 = build_model(cfg, device="cpu")
            m2.load_state_dict(blob["state"])
            pre = build_cell(cfg, ShapeConfig("p", 2 * S, B, "prefill"),
                             mesh, dtype=torch.float32, model=m2)
            dec = build_cell(cfg, ShapeConfig("d", 2 * S, B, "decode"),
                             mesh, dtype=torch.float32, model=m2)
            reqs = [Request(i, tokens[i].numpy(), max_new_tokens=6)
                    for i in range(B)]
            got = [r.out_tokens
                   for r in CellEngine(pre, dec, batch=B).generate(reqs)]
            out["greedy"] = [got, want]
        if rank == 0:
            torch.save({"got": full, "ref": ref, "lr": LR},
                       os.path.join(work, "update.pt"))
            with open(os.path.join(work, "out.json"), "w") as f:
                json.dump(out, f)
        dist.destroy_process_group()


    if __name__ == "__main__":
        work, world = sys.argv[1], int(sys.argv[2])
        mp.spawn(run, args=(world, work), nprocs=world)
''')


def _ref_weights(arch):
    jcfg = jax_smoke_config(arch)
    jmodel = jax_build_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.float32)
    return jmodel, params


def update_err(work) -> float:
    """The step's parameters against the reference AdamW step a gloo script
    saved under ``work``: the largest of each leaf's max |got - ref| over
    its tolerance, 1e-5 of the leaf's largest value plus 1e-4 of the step
    size.  Adam divides each element by its own gradient's magnitude, so
    an element whose gradient is far below its leaf's largest carries the
    gradient's f32 rounding (the order of the sharded partial sums) into
    its update as a relative error: the reference's zero-based norm
    scales, whose values after one step are of the order of lr, move by
    1e-8 of it."""
    blob = torch.load(Path(work) / "update.pt")
    got, ref, lr = blob["got"], blob["ref"], blob["lr"]
    return max(float((got[k].float() - ref[k]).abs().max())
               / (1e-5 * float(ref[k].abs().max()) + 1e-4 * lr)
               for k in ref)


def _gloo(tmp_path, arch, mesh, tokens, labels, state, greedy=False):
    script = tmp_path / "gloo_cell.py"
    script.write_text(GLOO)
    torch.save({"arch": arch, "mesh": list(mesh), "tokens": tokens,
                "labels": labels, "state": state, "greedy": greedy},
               tmp_path / "inputs.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, str(script), str(tmp_path),
                        str(mesh[0] * mesh[1])], capture_output=True,
                       text=True, cwd=str(ROOT), env=env, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return json.loads((tmp_path / "out.json").read_text())


def _inputs(vocab, B=4, S=16, seed=1):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, vocab, (B, S))),
            torch.from_numpy(rng.integers(0, vocab, (B, S))))


def test_sharded_loss_on_2x2_gloo_matches_single_process_and_reference(
        tmp_path):
    arch = "qwen1.5-0.5b"
    jmodel, params = _ref_weights(arch)
    cfg = get_smoke_config(arch)
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg)
    tokens, labels = _inputs(cfg.vocab)
    ref = float(jmodel.loss(params, {"tokens": jnp.asarray(tokens.numpy()),
                                     "labels": jnp.asarray(labels.numpy())}))
    out = _gloo(tmp_path, arch, (2, 2), tokens, labels, state, greedy=True)
    assert abs(out["sharded"] - out["single"]) <= 1e-5, out
    assert abs(out["sharded"] - ref) <= 1e-4, (out, ref)
    assert abs(out["step_loss"] - out["single"]) <= 1e-5, out
    assert out["grad_rel"] <= 1e-5, out
    assert out["finite"]
    assert update_err(tmp_path) <= 1.0 and out["moved"] > 0, out
    # vocab and heads on model, the embed dim on data
    assert out["local"]["embed"] == [cfg.padded_vocab // 2, cfg.d_model // 2]
    assert out["local"]["layers.0.wq"] == [cfg.d_model // 2,
                                           cfg.n_heads * cfg.hd // 2]
    got, want = out["greedy"]
    assert got == want


@pytest.mark.parametrize("arch,mesh", [("qwen3-moe-235b-a22b", (1, 4)),
                                       ("gemma3-27b", (1, 4)),
                                       ("qwen2-moe-a2.7b", (2, 2)),
                                       ("mamba2-130m", (2, 2)),
                                       ("hymba-1.5b", (1, 4))])
def test_sharded_loss_on_gloo(tmp_path, arch, mesh):
    """qwen3-moe: experts on ``model`` (4 of 16 a rank); gemma3: H 4 over
    KVH 2 on 4 ranks, so K / V are broadcast to the query heads;
    qwen2-moe on (2, 2): two token groups on ``data``, its experts and
    shared experts on ``model``; mamba2 on (2, 2): the SSD's 8 heads on
    ``model``; hymba on (1, 4): attention (K / V broadcast) beside the
    SSD, with meta tokens and a window.  Each on the reference's weights,
    its sharded loss within 1e-4 of the reference's ``model.loss``."""
    cfg = get_smoke_config(arch)
    jmodel, params = _ref_weights(arch)
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg)
    tokens, labels = _inputs(cfg.vocab, seed=2)
    ref = float(jmodel.loss(params, {"tokens": jnp.asarray(tokens.numpy()),
                                     "labels": jnp.asarray(labels.numpy())}))
    out = _gloo(tmp_path, arch, mesh, tokens, labels, state)
    m = mesh[1]
    assert abs(out["sharded"] - out["single"]) <= 1e-5, out
    assert abs(out["sharded"] - ref) <= 1e-4, (out, ref)
    assert abs(out["step_loss"] - out["single"]) <= 1e-5, out
    assert out["grad_rel"] <= 1e-5, out
    assert out["finite"]
    assert update_err(tmp_path) <= 1.0 and out["moved"] > 0, out
    if cfg.n_experts:
        assert out["rules"]["experts"] == "model"
        assert out["local"]["layers.0.we_gate"] == [
            cfg.n_experts // m, cfg.d_model // mesh[0], cfg.moe_d_ff]
    elif cfg.family == "ssm":
        assert out["local"]["layers.0.w_zx"] == [
            cfg.d_model // mesh[0], 2 * cfg.ssm_expand * cfg.d_model // m]
    else:
        assert cfg.n_heads % m == 0 and cfg.n_kv_heads % m
        assert out["local"]["layers.0.wq"] == [cfg.d_model,
                                               cfg.n_heads * cfg.hd // m]


def test_model_kernel_wrappers_refuse_fake_tensors():
    """The dry run's fake tensors never reach a wrapper: each raises (the
    model calls the plain versions on fake tensors itself)."""
    from repro_torch.kernels import flash_attention, router_topk, topk_gating
    with FakeTensorMode():
        q = torch.empty(1, 8, 2, 16)
        x, w = torch.empty(8, 16), torch.empty(16, 4)
        calls = (lambda: flash_attention.flash_attention(q, q, q),
                 lambda: flash_attention.flash_attention_bwd(
                     q, q, q, q, q, torch.empty(1, 2, 8)),
                 lambda: router_topk.router_topk(x, w, 2),
                 lambda: topk_gating.topk_gating(x, 2))
        for call in calls:
            with pytest.raises(TypeError, match="fake tensor"):
                call()


DTENSOR_REFUSAL = textwrap.dedent('''
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.kernels import flash_attention, router_topk, topk_gating
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
    def d(*shape):
        return DTensor.from_local(torch.randn(*shape), mesh,
                                  [Replicate(), Replicate()])
    q, x, w = d(1, 8, 2, 16), d(8, 16), d(16, 4)
    for call in (lambda: flash_attention.flash_attention(q, q, q),
                 lambda: router_topk.router_topk(x, w, 2),
                 lambda: topk_gating.topk_gating(x, 2)):
        try:
            call()
        except TypeError as e:
            assert "DTensor" in str(e), e
        else:
            raise AssertionError("a wrapper took a DTensor")
    print("REFUSED")
''')


def test_model_kernel_wrappers_refuse_dtensors():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", DTENSOR_REFUSAL],
                       capture_output=True, text=True, cwd=str(ROOT),
                       env=env, timeout=300)
    assert "REFUSED" in r.stdout, r.stdout[-2000:] + r.stderr[-2000:]


INT8DP = textwrap.dedent('''
    import json, os, sys
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp


    def run(rank, world, work):
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(work, "store"), world),
            rank=rank, world_size=world)
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor
        from repro_torch.configs import get_smoke_config
        from repro_torch.distributed import compression
        from repro_torch.launch.steps import build_compressed_dp_cell
        from repro_torch.models import build_model
        from repro_torch.models.config import ShapeConfig
        from repro_torch.optim import adamw_init, adamw_update
        LR = 1e-3
        blob = torch.load(os.path.join(work, "inputs.pt"))
        cfg = get_smoke_config(blob["arch"])
        mesh = init_device_mesh("cpu", (2, 1, 2),
                                mesh_dim_names=("pod", "data", "model"))
        state = blob["state"]
        tokens, labels = blob["tokens"], blob["labels"]
        B, S = tokens.shape

        def grads_of(t, l):
            m = build_model(cfg, device="cpu")
            m.load_state_dict(state)
            m.requires_grad_(True)
            gs = torch.autograd.grad(m.loss(t, l), list(m.parameters()),
                                     allow_unused=True,
                                     materialize_grads=True)
            return {k: g for (k, _), g in zip(m.named_parameters(), gs)}
        g_full = grads_of(tokens, labels)
        halves = [slice(i * B // 2, (i + 1) * B // 2) for i in (0, 1)]
        g_pods = [grads_of(tokens[h], labels[h]) for h in halves]
        model = build_model(cfg, device="cpu")
        model.load_state_dict(state)
        single = float(model.loss(tokens, labels))
        # the means the step applies, as the ring hands them over
        means, ring = [], compression.pairwise_compressed_mean

        def mean_spy(g, group, n_pods, ef=None):
            out = ring(g, group, n_pods, ef)
            means.append(out[0].clone())
            return out
        compression.pairwise_compressed_mean = mean_spy
        cell = build_compressed_dp_cell(cfg, ShapeConfig("t", S, B, "train"),
                                        mesh, dtype=torch.float32,
                                        model=model,
                                        lr_schedule=lambda step: LR)
        pod = mesh.get_coordinate()[0]
        half = halves[pod]
        params, opt, batch = cell.make_args({"tokens": tokens[half],
                                             "labels": labels[half]})
        sent = []
        inner = dist.batch_isend_irecv

        def spy(ops):
            sent.extend(str(op.tensor.dtype) for op in ops
                        if op.op is dist.isend)
            return inner(ops)
        dist.batch_isend_irecv = spy
        params, opt, loss = cell.fn(params, opt, batch)
        full = {k: p.detach().full_tensor() for k, p in params.items()}
        # the other pod's replica of every parameter, after the step
        other = {k: torch.empty_like(v) for k, v in full.items()}
        pod_group = mesh["pod"].get_group()
        me = dist.get_rank(pod_group)
        peer = dist.get_global_rank(pod_group, 1 - me)
        for k in full:
            ops = [dist.P2POp(dist.isend, full[k], peer),
                   dist.P2POp(dist.irecv, other[k], peer)]
            for w in inner(ops):
                w.wait()
        same = all(torch.equal(full[k], other[k]) for k in full)
        moved = max(float((full[k] - v).abs().max())
                    for k, v in state.items())
        mean = {k: DTensor.from_local(m, p.device_mesh, p.placements,
                                      run_check=False).full_tensor()
                for (k, p), m in zip(params.items(), means)}
        # each pod's int8 error is at most half a block's scale, max|g| /
        # 254, and the mean halves the sum; plus the sharded gradient's
        # f32 rounding against the single-process one
        wire = max(float((mean[k] - g_full[k]).abs().max())
                   / (max(float(g[k].abs().max()) for g in g_pods)
                      * (1 / 254 + 1e-5) + 1e-30) for k in mean)
        ref = {k: v.clone().float() for k, v in state.items()}
        adamw_update(ref, {k: v.clone() for k, v in mean.items()},
                     adamw_init(ref), LR)
        if rank == 0:
            torch.save({"got": full, "ref": ref, "lr": LR},
                       os.path.join(work, "update.pt"))
            with open(os.path.join(work, "out.json"), "w") as f:
                json.dump({"single": single, "loss": float(loss),
                           "same": same, "moved": moved,
                           "wire": sorted(set(sent)),
                           "mean_over_bound": wire,
                           "meta": cell.meta["grad_wire"]}, f)
        dist.destroy_process_group()


    if __name__ == "__main__":
        work, world = sys.argv[1], int(sys.argv[2])
        mp.spawn(run, args=(world, work), nprocs=world)
''')


def test_compressed_dp_cell_on_gloo(tmp_path):
    """``build_compressed_dp_cell`` (experimental) on a (pod 2, data 1,
    model 2) gloo mesh, each pod half of the batch: the step's loss is
    the whole batch's single-process loss within 1e-5, the gradients
    cross the pod axis as int8 payloads with f32 scales, the means the
    step applies are the whole batch's single-process gradient within the
    int8 error bound, the step is a single-process AdamW step on those
    means within ``update_err``'s tolerance, and both pods'
    parameters are the same bits after the step and have moved."""
    arch = "qwen1.5-0.5b"
    cfg = get_smoke_config(arch)
    model = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(3))
    tokens, labels = _inputs(cfg.vocab, seed=4)
    script = tmp_path / "int8dp.py"
    script.write_text(INT8DP)
    torch.save({"arch": arch, "tokens": tokens, "labels": labels,
                "state": model.state_dict()}, tmp_path / "inputs.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, str(script), str(tmp_path), "4"],
                       capture_output=True, text=True, cwd=str(ROOT),
                       env=env, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    out = json.loads((tmp_path / "out.json").read_text())
    assert abs(out["loss"] - out["single"]) <= 1e-5, out
    assert out["wire"] == ["torch.float32", "torch.int8"], out
    assert out["same"] and out["moved"] > 0, out
    assert out["mean_over_bound"] <= 1.0, out
    assert update_err(tmp_path) <= 1.0
    assert out["meta"] == "int8+error-feedback"
