"""The port's HLO analysis (``repro_torch.analysis``: ``dots``,
``hlostats.collective_stats``, ``roofline.roofline_terms``) against the
reference's, exactly, on ``tests/test_readers.py``'s ``HLO_MIN``, on
``tests/test_torch_hlo.py``'s ``HLO_RING`` (a collective of each kind in
a loop body and an async pair) and on a module JAX compiles on the CPU
inside the test; ``roofline_terms`` given the reference's hardware table
(the TPU's) equals the reference's, and by default takes the H100's."""

import pytest

from repro.analysis import dots as ref_dots
from repro.analysis.hlostats import collective_stats as ref_collective_stats
from repro.analysis.hlostats import iter_collectives as ref_iter
from repro.analysis.roofline import HW as REF_HW
from repro.analysis.roofline import roofline_terms as ref_roofline_terms
from repro_torch.analysis import dots, hlostats, roofline

from test_readers import HLO_MIN
from test_torch_hlo import HLO_RING


def _jax_module() -> str:
    """A jitted function with a loop of dots and a dot outside it,
    compiled on the CPU."""
    import jax
    import jax.numpy as jnp

    def f(x, y):
        z = jax.lax.fori_loop(0, 7, lambda i, a: jnp.tanh(a @ x), x)
        return (z @ y).sum()

    x = jnp.ones((64, 64), jnp.float32)
    y = jnp.ones((64, 32), jnp.float32)
    return jax.jit(f).lower(x, y).compile().as_text()


@pytest.fixture(scope="module")
def texts():
    return {"min": HLO_MIN, "ring": HLO_RING, "jax": _jax_module()}


@pytest.mark.parametrize("name", ["min", "ring", "jax"])
def test_dots_equal_the_reference(texts, name):
    hlo = texts[name]
    assert dots.dot_inventory(hlo) == ref_dots.dot_inventory(hlo)
    assert dots.summarize_dots(hlo) == ref_dots.summarize_dots(hlo)
    assert dots.summarize_dots(hlo, top=1) == \
        ref_dots.summarize_dots(hlo, top=1)
    assert dots.while_trip_counts(hlo) == ref_dots.while_trip_counts(hlo)
    if name == "jax":
        assert dots.dot_inventory(hlo)        # the module has dots


@pytest.mark.parametrize("name", ["min", "ring", "jax"])
@pytest.mark.parametrize("group", [1, 4, 256])
def test_collective_stats_equal_the_reference(texts, name, group):
    hlo = texts[name]
    assert list(hlostats.iter_collectives(hlo, group)) == \
        list(ref_iter(hlo, group))
    assert hlostats.collective_stats(hlo, group) == \
        ref_collective_stats(hlo, group)
    if name == "ring":
        assert hlostats.collective_stats(hlo, group)["total"]["count"] >= 4


@pytest.mark.parametrize("name", ["min", "ring", "jax"])
def test_roofline_terms_equal_the_reference(texts, name):
    hlo = texts[name]
    flops = sum(d["flops_weighted"] for d in dots.dot_inventory(hlo)) or 1.0
    wire = hlostats.collective_stats(hlo, 4)["total"]["wire_bytes"]
    for chips, model_flops in ((4, None), (256, flops / 2), (512, 3e12)):
        args = (flops * chips, 7.5e9 * chips, wire, chips, model_flops)
        assert roofline.roofline_terms(*args, hw=REF_HW) == \
            ref_roofline_terms(*args, hw=REF_HW)
        assert roofline.roofline_terms(*args) == \
            ref_roofline_terms(*args, hw=roofline.HW_H100)


def test_wire_bytes_ring_factors():
    """The per-kind factors the dry run prices torch collectives with."""
    w = hlostats.wire_bytes
    assert w("all-gather", 1024, 64, 16) == 15 / 16 * 1024
    assert w("all-reduce", 0, 1024, 4) == 2 * 3 / 4 * 1024
    assert w("reduce-scatter", 64, 1024, 16) == 15 / 16 * 1024
    assert w("all-to-all", 1024, 1024, 2) == 512
    assert w("collective-permute", 10, 1024, 8) == 1024
    assert w("all-reduce", 0, 1024, 1) == 0.0
    s = hlostats.summarize([("all-gather", 1024, 64, 16),
                            ("all-reduce", 0, 1024, 4)])
    assert s["total"]["count"] == 2
    assert s["total"]["wire_bytes"] == 15 / 16 * 1024 + 1536
