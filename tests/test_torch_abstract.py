"""The model side's abstract helpers and the checkpoint's restore options,
against the reference.

``layers.map_defs`` / ``init_tree`` / ``abstract_tree``,
``LM.abstract_params``, ``LM.init_cache(abstract=True)`` and
``adamw.abstract_adamw_state`` give ``meta``-device stand-ins where the
reference gives ``jax.ShapeDtypeStruct``: the same element counts by
dtype as the reference's trees (the port keeps one tensor a layer where
the reference stacks layers), and the shapes and dtypes of the port's own
allocated trees.  ``CheckpointManager.restore(verify=False)`` skips the
sha256 check and ``device_put(key, leaf)`` places each leaf, as the
reference's.
"""

import os
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro.models import layers as jax_layers
from repro.optim import adamw as jax_adamw
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model
from repro_torch.models import layers as port_layers
from repro_torch.models.layers import (ParamDef, abstract_tree, init_param,
                                       init_tree, is_def, map_defs)
from repro_torch.optim.adamw import abstract_adamw_state, adamw_init

ARCHS = ["pipit-lm-100m", "qwen2-moe-a2.7b", "hymba-1.5b", "whisper-medium"]


def _counts(leaves):
    """Elements by dtype name over a tree's leaves."""
    out = Counter()
    for x in leaves:
        out[str(x.dtype).replace("torch.", "")] += int(np.prod(x.shape))
    return out


def _model(arch):
    return build_model(get_smoke_config(arch), dtype=torch.bfloat16,
                       device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_the_references(arch):
    model = _model(arch)
    got = model.abstract_params()
    assert all(t.device.type == "meta" and t.dtype == torch.bfloat16
               for t in got.values())
    assert {k: tuple(t.shape) for k, t in got.items()} == {
        k: tuple(p.shape) for k, p in model.state_dict().items()}
    want = jax_build_model(jax_smoke_config(arch)).abstract_params(
        jnp.bfloat16)
    assert _counts(got.values()) == _counts(jax.tree_util.tree_leaves(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_cache_matches_the_allocated_one(arch):
    model = _model(arch)
    got = model.init_cache(2, 24, dtype=torch.bfloat16, abstract=True)
    real = model.init_cache(2, 24, dtype=torch.bfloat16)
    assert [{k: (tuple(t.shape), t.dtype, t.device.type)
             for k, t in layer.items()} for layer in got] == [
        {k: (tuple(t.shape), t.dtype, "meta") for k, t in layer.items()}
        for layer in real]
    if arch != "whisper-medium":  # its cross K / V are not in init_cache
        want = jax_build_model(jax_smoke_config(arch)).init_cache(
            2, 24, jnp.bfloat16, abstract=True)
        assert _counts(t for layer in got for t in layer.values()) == \
            _counts(jax.tree_util.tree_leaves(want))


def test_map_defs_and_abstract_tree_keep_the_tree():
    def make(mod):
        return {"a": mod.ParamDef((3, 4), (None, None)),
                "b": [mod.ParamDef((5,), (None,), "zeros"),
                      (mod.ParamDef((2, 2), (None, None), "ones"), 7)],
                "n": None}

    def shape(d):
        return d.shape if hasattr(d, "shape") else -d

    shapes = map_defs(shape, make(port_layers))
    assert shapes == {"a": (3, 4), "b": [(5,), ((2, 2), -7)], "n": None}
    assert shapes == jax_layers.map_defs(shape, make(jax_layers))
    port_tree = {"a": ParamDef((3, 4), (None, None)),
                 "b": [ParamDef((5,), (None,), "zeros")]}
    assert is_def(port_tree["a"]) and not is_def(port_tree["b"])
    ab = abstract_tree(port_tree, torch.float16)
    assert ab["a"].device.type == "meta" and ab["a"].dtype == torch.float16
    assert tuple(ab["b"][0].shape) == (5,)


def test_init_tree_draws_each_leaf_by_the_references_rule():
    tree = {"w": ParamDef((64, 32), (None, None), scale=2.0),
            "z": ParamDef((8,), (None,), "zeros"),
            "o": [ParamDef((4, 4), (None, None), "ones")]}
    got = init_tree(tree, 3, dtype=torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(3)
    want = init_param(tree["w"], gen, torch.empty(64, 32))
    torch.testing.assert_close(got["w"], want, rtol=0, atol=0)
    assert torch.equal(got["z"], torch.zeros(8))
    assert torch.equal(got["o"][0], torch.ones(4, 4))
    # the reference's scale: std = scale / sqrt(fan_in), fan_in = shape[-2]
    assert abs(float(got["w"].std()) - 2.0 / np.sqrt(64)) < 0.02
    again = init_tree(tree, torch.Generator().manual_seed(3),
                      dtype=torch.bfloat16, device="cpu")
    assert again["w"].dtype == torch.bfloat16
    torch.testing.assert_close(again["w"].float(), want.bfloat16().float(),
                               rtol=0, atol=0)


def test_abstract_adamw_state_is_adamw_inits_layout():
    params = _model("pipit-lm-100m").abstract_params()
    st = abstract_adamw_state(params)
    real = adamw_init({k: torch.empty(t.shape, dtype=torch.bfloat16)
                       for k, t in params.items()})
    assert st.step == real.step == 0
    for m in ("m", "v"):
        assert {k: (tuple(t.shape), t.dtype, t.device.type)
                for k, t in getattr(st, m).items()} == {
            k: (tuple(t.shape), t.dtype, "meta")
            for k, t in getattr(real, m).items()}
    want = jax_adamw.abstract_adamw_state(
        jax_build_model(jax_smoke_config("pipit-lm-100m")).abstract_params())
    assert _counts(st.m.values()) == _counts(jax.tree_util.tree_leaves(
        want.m))


def _damaged(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    tree = {"a": torch.arange(10, dtype=torch.float32),
            "b": {"c": torch.ones((3, 4), dtype=torch.bfloat16)}}
    mgr.save(4, tree)
    path = os.path.join(str(tmp_path), "step_00000004", "arrays.npz")
    data = dict(np.load(path))
    data["a"] = data["a"] + 1
    np.savez(path, **data)
    return mgr, tree


def test_restore_verify_false_skips_the_hash(tmp_path):
    mgr, tree = _damaged(tmp_path)
    with pytest.raises(IOError, match="checksum mismatch for a"):
        mgr.restore(4, tree)
    out = mgr.restore(4, tree, verify=False)
    np.testing.assert_array_equal(out["a"].numpy(), np.arange(10) + 1)
    assert out["b"]["c"].dtype == torch.bfloat16


def test_restore_device_put_places_each_leaf(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.full((4,), 1.5, dtype=torch.bfloat16)}}
    mgr.save(1, tree)
    seen = []

    def put(key, leaf):
        seen.append((key, leaf.device.type, leaf.dtype))
        return leaf * 2

    out = mgr.restore(1, tree, device_put=put)
    assert seen == [("a", "cpu", torch.float32),
                    ("b/c", "cpu", torch.bfloat16)]
    torch.testing.assert_close(out["a"], tree["a"] * 2, rtol=0, atol=0)
    torch.testing.assert_close(out["b"]["c"], tree["b"]["c"] * 2, rtol=0,
                               atol=0)
