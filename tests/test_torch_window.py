"""The port's sliding-window attention, ring decode and meta-token decode
against the reference on the CPU.

``local_attention`` (the flash kernel's plain version with ``window=``)
against the reference's banded scan and its ``reference_attention``;
windowed attention with a visible prefix against ``chunked_attention``;
``_ring_decode`` against the reference's; ``_merge_meta`` against the
reference's where no meta position is left in the ring, and, where one
is, against the reference's own full attention (``chunked_attention``
with ``window`` and ``prefix_len``, the mask prefill and forward use),
which the reference's ``_merge_meta`` misses (it attends to those meta
positions twice; ROADMAP §C).  The serve caches' shapes and entries
against the reference's ``cache_defs``.  Tolerance 3e-5 (f32), as
``tests/test_models_math.py`` holds attention.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import attention as ref_attn
from repro.models import blocks as ref_blocks
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import flash_attention
from repro_torch.models import attention, blocks

TOL = 3e-5


def _qkv(seed, B, S, H, KVH, D, Sk=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk or S, KVH, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk or S, KVH, D)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("S,window,H,KVH", [(8, 4, 2, 1), (50, 16, 4, 2),
                                            (150, 40, 2, 1), (33, 64, 5, 5),
                                            (130, 16, 5, 1)])
def test_local_attention_matches_reference(S, window, H, KVH):
    q, k, v = _qkv(S * window, 2, S, H, KVH, 16)
    before = flash_attention.LAUNCHES
    got = attention.local_attention(*_t(q, k, v), window=window)
    assert flash_attention.LAUNCHES == before      # the plain version
    want = ref_attn.local_attention(*_j(q, k, v), window=window, chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    oracle = ref_attn.reference_attention(*_j(q, k, v), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=TOL)


def test_local_attention_is_self_attention():
    q, k, v = _qkv(0, 1, 8, 2, 1, 16, Sk=9)
    with pytest.raises(ValueError, match="self-attention"):
        attention.local_attention(*_t(q, k, v), window=4)


@pytest.mark.parametrize("S,window,prefix", [(28, 16, 8), (40, 8, 8),
                                             (1200, 1024, 128)])
def test_window_with_prefix_matches_reference(S, window, prefix):
    q, k, v = _qkv(S + prefix, 1, S, 5, 1, 16)
    got = attention.chunked_attention(*_t(q, k, v), window=window,
                                      prefix_len=prefix)
    want = ref_attn.chunked_attention(*_j(q, k, v), window=window,
                                      prefix_len=prefix)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def _ring(k_full, pos, Sc):
    """The ring an Sc-slot cache holds after positions 0..pos were
    written (position p at slot p % Sc)."""
    B, _, KVH, D = k_full.shape
    ring = np.zeros((B, Sc, KVH, D), np.float32)
    for p in range(pos + 1):
        ring[:, p % Sc] = k_full[:, p]
    return ring


@pytest.mark.parametrize("pos,Sc", [(3, 16), (15, 16), (16, 16), (40, 16)])
def test_ring_decode_matches_reference(pos, Sc):
    q, k, v = _qkv(pos, 2, 1, 4, 2, 16, Sk=pos + 1)
    kc, vc = _ring(k, pos, Sc), _ring(v, pos, Sc)
    kv_len = min(pos + 1, Sc)
    got = blocks._ring_decode(*_t(q, kc, vc), kv_len)
    want = ref_blocks._ring_decode(*_j(q, kc, vc), kv_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    # and the windowed full attention of the token at pos
    full = ref_attn.chunked_attention(*_j(q, k, v), window=Sc,
                                      q_offset=pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(full), atol=TOL)


def _meta_case(pos, Sc, M, seed=0):
    q, k, v = _qkv(seed + pos, 2, 1, 4, 2, 16, Sk=pos + 1)
    args = (q, k[:, :M], v[:, :M], _ring(k, pos, Sc), _ring(v, pos, Sc))
    # the full forward's mask: window Sc, the first M keys visible
    full = ref_attn.chunked_attention(*_j(q, k, v), window=Sc,
                                      prefix_len=M, q_offset=pos)
    return args, np.asarray(full)


@pytest.mark.parametrize("pos", [23, 24, 40])
def test_merge_meta_matches_reference_past_the_meta_tokens(pos):
    """pos >= Sc + M - 1: no meta position is left in the ring, and the
    reference is exact."""
    Sc, M = 16, 8
    args, full = _meta_case(pos, Sc, M)
    got = blocks._merge_meta(*_t(*args), pos, Sc)
    want = ref_blocks._merge_meta(*_j(*args), pos, Sc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    np.testing.assert_allclose(got.numpy(), full, atol=TOL)


@pytest.mark.parametrize("pos", [8, 12, 16, 22])
def test_merge_meta_counts_each_meta_token_once(pos):
    """pos < Sc + M - 1: meta positions are still in the ring.  The
    reference's ``_merge_meta`` attends to them twice and misses its own
    full attention; the port's equals it."""
    Sc, M = 16, 8
    args, full = _meta_case(pos, Sc, M)
    got = blocks._merge_meta(*_t(*args), pos, Sc)
    np.testing.assert_allclose(got.numpy(), full, atol=TOL)
    ref = np.asarray(ref_blocks._merge_meta(*_j(*args), pos, Sc))
    assert np.abs(ref - full).max() > 100 * TOL


def test_slot_positions_follow_the_ring_invariant():
    for Sc in (1, 5, 16):
        for pos in range(40):
            got = blocks._slot_positions(pos, Sc, "cpu").tolist()
            for s, p in enumerate(got):
                held = [x for x in range(pos + 1) if x % Sc == s]
                assert p == (held[-1] if held else p), (Sc, pos, s)
                assert (p < 0) == (not held)


@pytest.mark.parametrize("arch", ["gemma3-27b", "hymba-1.5b",
                                  "mamba2-130m"])
@pytest.mark.parametrize("cache_len", [8, 64])
def test_cache_defs_match_reference(arch, cache_len):
    from repro.models.lm import plan_layers as ref_plan
    from repro_torch.models.lm import plan_layers
    jcfg = jax_smoke_config(arch)
    cfg = get_smoke_config(arch)
    pattern, n_periods, tail = ref_plan(jcfg)
    want = list(pattern) * n_periods + list(tail)
    specs = plan_layers(cfg)
    assert [dataclasses.asdict(s) for s in specs] == \
        [dataclasses.asdict(s) for s in want]
    for spec, jspec in zip(specs, want):
        got = blocks.cache_defs(cfg, spec, 3, cache_len)
        ref = ref_blocks.cache_defs(jcfg, jspec, 3, cache_len)
        assert {k: d.shape for k, d in got.items()} == \
            {k: d.shape for k, d in ref.items()}
        assert set(blocks.layer_defs(cfg, spec)) == \
            set(ref_blocks.layer_defs(jcfg, jspec))
