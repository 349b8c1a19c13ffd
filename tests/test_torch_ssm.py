"""The port's Mamba-2 SSD core (``repro_torch.models.ssm``) against the
reference's (``repro.models.ssm``) on the CPU.

The same numpy-seeded inputs go through both: ``ssd_chunked`` and
``ssd_reference`` (outputs and final state), a carried initial state,
the recurrent ``ssd_step`` against the reference's steps and against the
chunked form, ``causal_conv1d`` and ``conv1d_step``.  Tolerances are
those of ``tests/test_models_math.py``: 2e-4 for the SSD, 1e-5 for the
convolution.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as ref_ssm
from repro_torch.models import ssm

SSD_TOL = 2e-4
CONV_TOL = 1e-5


def _ssd_inputs(seed, B, S, H, P, N):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, H, P)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    return x, dt, A, Bm, Cm


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("S,chunk", [(4, 8), (17, 8), (64, 32), (130, 64),
                                     (100, 256)])
def test_ssd_chunked_matches_reference(S, chunk):
    args = _ssd_inputs(S, 2, S, 3, 8, 4)
    yr, hr = ref_ssm.ssd_chunked(*_j(*args), chunk=chunk)
    yc, hc = ssm.ssd_chunked(*_t(*args), chunk=chunk)
    np.testing.assert_allclose(yc.numpy(), np.asarray(yr), atol=SSD_TOL)
    np.testing.assert_allclose(hc.numpy(), np.asarray(hr), atol=SSD_TOL)
    ys, hs = ref_ssm.ssd_reference(*_j(*args))
    np.testing.assert_allclose(yc.numpy(), np.asarray(ys), atol=SSD_TOL)
    np.testing.assert_allclose(hc.numpy(), np.asarray(hs), atol=SSD_TOL)


@pytest.mark.parametrize("S", [1, 9, 33])
def test_ssd_reference_matches_reference(S):
    args = _ssd_inputs(100 + S, 2, S, 2, 4, 3)
    yr, hr = ref_ssm.ssd_reference(*_j(*args))
    y, h = ssm.ssd_reference(*_t(*args))
    assert h.dtype == torch.float32 and y.shape == (2, S, 2, 4)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=SSD_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), atol=SSD_TOL)


def test_ssd_chunked_carries_an_initial_state():
    args = _ssd_inputs(7, 1, 40, 2, 4, 3)
    h0 = np.random.default_rng(8).standard_normal((1, 2, 4, 3)).astype(
        np.float32)
    yr, hr = ref_ssm.ssd_chunked(*_j(*args), chunk=16, h0=jnp.asarray(h0))
    y, h = ssm.ssd_chunked(*_t(*args), chunk=16, h0=torch.from_numpy(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=SSD_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), atol=SSD_TOL)
    # two halves, the second from the first's state, give the whole
    x, dt, A, Bm, Cm = _t(*args)
    y1, h1 = ssm.ssd_chunked(x[:, :25], dt[:, :25], A, Bm[:, :25],
                             Cm[:, :25], chunk=16, h0=torch.from_numpy(h0))
    y2, h2 = ssm.ssd_chunked(x[:, 25:], dt[:, 25:], A, Bm[:, 25:],
                             Cm[:, 25:], chunk=16, h0=h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(),
                               atol=SSD_TOL)
    np.testing.assert_allclose(h2.numpy(), h.numpy(), atol=SSD_TOL)


def test_ssd_step_matches_reference_and_the_chunked_form():
    x, dt, A, Bm, Cm = _ssd_inputs(0, 1, 20, 2, 4, 3)
    yc, _ = ssm.ssd_chunked(*_t(x, dt, A, Bm, Cm), chunk=8)
    h = torch.zeros((1, 2, 4, 3))
    jh = jnp.zeros((1, 2, 4, 3))
    for t in range(20):
        jh, jy = ref_ssm.ssd_step(jh, *_j(x[:, t], dt[:, t], A, Bm[:, t],
                                          Cm[:, t]))
        h, y = ssm.ssd_step(h, *_t(x[:, t], dt[:, t], A, Bm[:, t],
                                   Cm[:, t]))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=SSD_TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=SSD_TOL)
        np.testing.assert_allclose(y.numpy(), yc[:, t].numpy(), atol=SSD_TOL)


def test_ssd_step_keeps_the_state_in_f32_for_bf16_inputs():
    x, dt, A, Bm, Cm = _ssd_inputs(3, 2, 1, 2, 4, 3)
    h = torch.zeros((2, 2, 4, 3))
    xt, dtt, At, bt, ct = _t(x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0])
    h, y = ssm.ssd_step(h, xt.bfloat16(), dtt, At, bt.bfloat16(),
                        ct.bfloat16())
    assert h.dtype == torch.float32 and y.dtype == torch.bfloat16


@pytest.mark.parametrize("S,C", [(12, 6), (1, 5), (40, 16)])
def test_causal_conv1d_matches_reference(S, C):
    rng = np.random.default_rng(S * C)
    x = rng.standard_normal((2, S, C)).astype(np.float32)
    w = (rng.standard_normal((4, C)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(C) * 0.1).astype(np.float32)
    want = ref_ssm.causal_conv1d(*_j(x, w, b))
    got = ssm.causal_conv1d(*_t(x, w, b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=CONV_TOL)


def test_conv1d_step_matches_reference_and_the_full_conv():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, 6)).astype(np.float32)
    w = (rng.standard_normal((4, 6)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(6) * 0.1).astype(np.float32)
    full = ssm.causal_conv1d(*_t(x, w, b))
    st = torch.zeros((2, 3, 6))
    jst = jnp.zeros((2, 3, 6))
    for t in range(12):
        jst, jy = ref_ssm.conv1d_step(jst, *_j(x[:, t], w, b))
        st, y = ssm.conv1d_step(st, *_t(x[:, t], w, b))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=CONV_TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(jst), atol=0)
        np.testing.assert_allclose(y.numpy(), full[:, t].numpy(),
                                   atol=CONV_TOL)


def test_ssd_chunked_has_gradients():
    """Training through the SSM (a later slice) needs autograd through the
    chunk loop: the gradient of a sum is finite and nonzero."""
    x, dt, A, Bm, Cm = _t(*_ssd_inputs(5, 1, 24, 2, 4, 3))
    x.requires_grad_(True)
    y, h = ssm.ssd_chunked(x, dt, A, Bm, Cm, chunk=8)
    (y.sum() + h.sum()).backward()
    assert torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0


def test_ssd_chunked_gradient_stays_finite_past_the_exp_range():
    """A chunk whose decay sums past f32's exp range (|A| dt summed over
    the chunk above ~88, as at full width when training hymba-1.5b and
    mamba2-130m): the reference's ``where(mask, exp(ldiff), 0)`` gives a
    NaN gradient (0 x inf above the diagonal), the port, which masks
    before the exp, the same forward within ``SSD_TOL`` and the
    sequential oracle's gradients for every input within 1e-4 of each
    one's largest."""
    import jax
    x, dt, A, Bm, Cm = _ssd_inputs(11, 2, 64, 3, 8, 4)
    A = np.full_like(A, -4.0)                # ~180 summed over the chunk
    rng = np.random.default_rng(12)
    ry = rng.standard_normal(x.shape).astype(np.float32)
    rh = rng.standard_normal((2, 3, 8, 4)).astype(np.float32)

    def jloss(*a):
        y, h = ref_ssm.ssd_chunked(*a, chunk=64)
        return jnp.sum(y * ry) + jnp.sum(h * rh)

    jg = jax.grad(jloss, argnums=tuple(range(5)))(*_j(x, dt, A, Bm, Cm))
    assert any(bool(jnp.isnan(g).any()) for g in jg)
    grads = []
    for f in (lambda *a: ssm.ssd_chunked(*a, chunk=64), ssm.ssd_reference):
        ts = [t.requires_grad_(True) for t in _t(x, dt, A, Bm, Cm)]
        y, h = f(*ts)
        ((y * torch.from_numpy(ry)).sum()
         + (h * torch.from_numpy(rh)).sum()).backward()
        grads.append([t.grad for t in ts])
        if f is ssm.ssd_reference:
            continue
        want_y, _h = ref_ssm.ssd_chunked(*_j(x, dt, A, Bm, Cm), chunk=64)
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                                   atol=SSD_TOL)
    for got, want in zip(*grads):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-4 * float(want.abs().max()))
