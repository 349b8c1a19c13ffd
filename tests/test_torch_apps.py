"""The port's application generators (``repro_torch.tracegen.apps``)
against the reference's: the same events, column for column (names and
category tables, codes, timestamps, sizes, partners, tags, threads), in
the same row order, with the same label, from the same seed — at two
seeds and under a ``perturb`` that slows one function."""

import numpy as np
import pytest

from repro import tracegen as rtg
from repro_torch import tracegen as tg

#: generator -> (small keyword arguments, a function to perturb)
APPS = {
    "gol": ({"nprocs": 4, "iters": 3}, "compute_cells()"),
    "stencil3d": ({"nprocs": 8, "iters": 2}, "kernel_update()"),
    "amg_vcycle": ({"nprocs": 5, "iters": 2}, "smooth_l1()"),
    "kripke_sweep": ({"nprocs": 5, "iters": 2}, "sweep_cells()"),
    "tortuga": ({"nprocs": 6, "iters": 3}, "computeRhs"),
    "loimos": ({"nprocs": 30, "iters": 2}, "Idle"),
    "axonn_training": ({"nprocs": 3, "iters": 2, "version": 2}, "backward"),
}


def assert_same_events(got, want):
    assert got.label == want.label
    a, b = got.events, want.events
    assert list(a.columns) == list(b.columns)
    assert len(a) == len(b)
    for c in b.columns:
        x, y = a.column(c), b.column(c)
        if hasattr(y, "codes"):
            assert list(x.categories) == list(y.categories), c
            np.testing.assert_array_equal(x.codes, y.codes, err_msg=c)
        else:
            assert x.dtype == y.dtype, c
            np.testing.assert_array_equal(x, y, err_msg=c)


@pytest.mark.parametrize("perturbed", [False, True])
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("app", sorted(APPS))
def test_generator_equals_the_reference(app, seed, perturbed):
    kw, func = APPS[app]
    kw = dict(kw, seed=seed)
    if perturbed:
        kw["perturb"] = {func: 1.7}
    got = getattr(tg, app)(device="cpu", **kw)
    assert str(got.device) == "cpu"
    assert_same_events(got, getattr(rtg, app)(**kw))


@pytest.mark.parametrize("app", ["axonn_training", "loimos", "tortuga"])
def test_defaults_equal_the_reference(app):
    assert_same_events(getattr(tg, app)(device="cpu"),
                       getattr(rtg, app)())


def test_regression_pair_equals_the_reference():
    got = tg.regression_pair("gol", "compute_cells()", factor=2.0,
                             nprocs=3, iters=2, device="cpu")
    want = rtg.regression_pair("gol", "compute_cells()", factor=2.0,
                               nprocs=3, iters=2)
    for g, w in zip(got, want):
        assert_same_events(g, w)
    with pytest.raises(ValueError, match="unknown app"):
        tg.regression_pair("nope")
