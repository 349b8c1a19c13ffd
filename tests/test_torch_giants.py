"""qwen1.5-110b and qwen3-moe-235b-a22b in the port against the JAX
reference on the CPU, at the model level.

Each smoke config (qwen1.5-110b-smoke: dense, 2 layers, d_model 64, 8
heads of 8 over 2 KV heads, QKV bias; qwen3-moe-smoke: 3 layers of 16
routed experts top-4 and no shared expert, capacity factor 8) with the
reference's own float32 weights (``init``, seed 0) carried across by
:func:`repro_torch.convert.params_from_jax`, fed the batch of
``tests/test_models.py``: the configs and both parameter counts, every
leaf carried, the forward within 1e-4, prefill and every decode step
within 1e-4 of the reference's and of its full forward, the loss within
1e-5 and every gradient within 1e-5 of its largest element, the serve
cache's entries, and the engine's greedy tokens against the reference
engine's.  Every kernel runs its plain version here (CPU tensors).
Helpers are ``tests/test_torch_encdec.py``'s.
"""

import pytest

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro_torch.configs import get_config, get_smoke_config
from test_torch_encdec import (check_configs, check_engine, check_forward,
                               check_init_cache, check_loss_and_grads,
                               check_prefill_decode, check_state_dict, P)

GIANTS = ("qwen1.5-110b", "qwen3-moe-235b-a22b")


@pytest.mark.parametrize("arch", GIANTS)
def test_configs_match_reference(arch):
    check_configs(arch)
    for port, ref in ((get_config, jax_config),
                      (get_smoke_config, jax_smoke_config)):
        assert port(arch).active_param_count() == \
            ref(arch).active_param_count()


@pytest.mark.parametrize("arch", GIANTS)
def test_params_from_jax_carries_every_leaf(arch):
    check_state_dict(arch)


@pytest.mark.parametrize("arch", GIANTS)
def test_forward_logits_match(arch):
    assert check_forward(arch) == 0


@pytest.mark.parametrize("arch", GIANTS)
def test_prefill_and_every_decode_step_match(arch):
    assert check_prefill_decode(arch) == P


@pytest.mark.parametrize("arch", GIANTS)
def test_loss_and_every_gradient_match_jax(arch):
    check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", GIANTS)
def test_init_cache_matches_reference(arch):
    check_init_cache(arch)


@pytest.mark.parametrize("arch", GIANTS)
def test_serve_queue_matches_reference_engine(arch):
    check_engine(arch)
