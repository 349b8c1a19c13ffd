"""counts.py against operations and bytes worked out by hand at the
cells' shapes."""

import pytest

from cardbench import counts, modelcfg
from cardbench.reference import model as M


def arch(name):
    return M.arch_from_config(modelcfg.load(name))


def test_qwen2moe_step_by_hand():
    a = arch("qwen2-moe-a2.7b-4l")
    attn = 4 * 2048 * 2048                    # wq, wk, wv, wo (16 x 128)
    moe = 2048 * 60 + 4 * 3 * 2048 * 1408 + 3 * 2048 * 5632 + 2048
    assert counts.layer_params_per_token(a) == attn + moe == 86_108_160
    dense = 2 * 8192 * (4 * 86_108_160 + 2048 * 152_064)
    att = 4 * 128 * 16 * (2048 * 2049 // 2) * 4 * 4
    assert counts.train_step_flops(a, 4, 2048) == 3 * (dense + att)
    assert 33.0e12 < counts.train_step_flops(a, 4, 2048) < 33.2e12


def test_codeqwen_step_by_hand():
    a = arch("codeqwen1.5-7b-8l")
    # wq, wo 32 x 128; wk, wv 4 x 128 (GQA); the SwiGLU
    per = 2 * 4096 * 4096 + 2 * 4096 * 512 + 3 * 4096 * 13440
    assert counts.layer_params_per_token(a) == per == 202_899_456
    dense = 2 * 8192 * (8 * per + 4096 * 92416)
    att = 4 * 128 * 32 * (2048 * 2049 // 2) * 8 * 4
    assert counts.train_step_flops(a, 4, 2048) == 3 * (dense + att)


@pytest.mark.parametrize("B,S,H,KVH,D", [(4, 2048, 16, 16, 128),
                                         (4, 2048, 32, 4, 128)])
def test_flash_bounds_by_hand(B, S, H, KVH, D):
    pairs = S * (S + 1) // 2
    ops_b, nb_b = counts.flash_bwd(B, S, H, KVH, D)
    assert ops_b == 10 * D * pairs * B * H
    assert nb_b == 2 * (4 * B * S * H * D + 4 * B * S * KVH * D) \
        + 4 * B * H * S
    # bound by operations at the cells' shapes
    assert counts.bound_s(ops_b, nb_b) == ops_b / 989e12


def test_bound_is_the_larger_of_operations_and_bytes():
    # a short sequence of many heads reads more than it computes
    ops, nb = counts.flash_bwd(64, 16, 64, 64, 128)
    assert nb / 3.35e12 > ops / 989e12
    assert counts.bound_s(ops, nb) == nb / 3.35e12
