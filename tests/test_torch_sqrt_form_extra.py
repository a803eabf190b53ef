"""Parity of the port's last public functions with the JAX package,
float64 on the CPU, numpy-seeded inputs: ``sqrt_form``'s ``is_sqrt``,
``factor_from_cov`` (B7's plain version on the CPU), ``noise_rows``,
``noise_factor`` and ``factor_propagate``, and ``features``'
single-feature ``subfilter_update``. Counterparts of
``tests/test_sqrt_form.py::test_noise_factor_frozen_rows``,
``::test_factor_from_cov_roundtrip`` and
``tests/test_jacobians.py::test_subfilter_converges_depth``.

Tolerances (absolute): 1e-12 against the reference for the factors (the
same float64 Cholesky in another operation order), 1e-10 for the round
trip S S^T = P and for the subfilter's outputs over its 30 steps, 1e-12
between the subfilter and a row of its table form; excluded and
noise-free rows exactly 0 in both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xivo_tpu.filter import features as jf
from xivo_tpu.filter import sqrt_form as js
from xivo_tpu.filter.config import VIOConfig as JaxVIOConfig
from xivo_tpu_torch.filter import features as tf
from xivo_tpu_torch.filter import layout as L
from xivo_tpu_torch.filter import sqrt_form as ts
from xivo_tpu_torch.filter.config import VIOConfig
from xivo_tpu_torch.filter.state import MotionState as TMotion

import test_jacobians
from test_torch_pipeline import jax_cfg, torch_cfg

torch.set_num_threads(2)
FACTOR_TOL = 1e-12      # a factor against the reference's
ROUNDTRIP_TOL = 1e-10   # S S^T against P
SUBFILTER_TOL = 1e-10   # the subfilter's outputs, step by step
TABLE_TOL = 1e-12       # a table row against the single call (the batched
                        # matmuls sum in another order: ~2e-15 is seen)


def t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=tol)


class TinyDims:
    full = 20
    n_features = 2


def psd_with_dead_rows(rng, lead, D, dead):
    """Random PSD (lead..., D, D) covariances with rows/cols `dead` zero."""
    A = rng.standard_normal(lead + (D, D)) * 0.3
    P = A @ np.swapaxes(A, -1, -2) + 0.1 * np.eye(D)
    P[..., dead, :] = 0.0
    P[..., :, dead] = 0.0
    return P


def test_is_sqrt():
    for form in ("sqrt", "full"):
        jc = JaxVIOConfig(propagation_mode="fast", covariance_form=form)
        tc = VIOConfig(propagation_mode="fast", covariance_form=form)
        assert ts.is_sqrt(tc) == js.is_sqrt(jc) == (form == "sqrt")


@pytest.mark.parametrize("lead", [(), (3,), (2, 2)])
def test_factor_from_cov_matches_reference(lead):
    rng = np.random.default_rng(9 + len(lead))
    D, dead = TinyDims.full, [3, 11]
    P = psd_with_dead_rows(rng, lead, D, dead)
    S = ts.factor_from_cov(t(P), TinyDims).numpy()
    Sj = np.asarray(js.factor_from_cov(jnp.asarray(P), TinyDims))
    assert S.shape == Sj.shape == lead + (D, D + 3 * TinyDims.n_features)
    close(S, Sj, FACTOR_TOL)
    close(S @ np.swapaxes(S, -1, -2), P, ROUNDTRIP_TOL)
    for X in (S, Sj):
        assert np.abs(X[..., dead, :]).max() == 0.0
        assert np.abs(X[..., :, dead]).max() == 0.0
        assert np.abs(X[..., D:]).max() == 0.0
        assert np.abs(np.triu(X[..., :D], 1)).max() == 0.0


@pytest.mark.parametrize("qmodel", [{}, {"Qmodel_Wbc": 1e-4},
                                    {"Qmodel_Wsg": 1e-4},
                                    {"Qmodel_Wbc": 1e-4, "Qmodel_Wsg": 1e-4}])
def test_noise_factor_matches_reference(qmodel):
    jc = JaxVIOConfig(propagation_mode="fast", covariance_form="sqrt",
                      **qmodel)
    tc = VIOConfig(propagation_mode="fast", covariance_form="sqrt", **qmodel)
    rows = ts.noise_rows(tc)
    assert rows == js.noise_rows(jc)
    assert len(rows) == 15 + 3 * ("Qmodel_Wbc" in qmodel) \
        + 2 * ("Qmodel_Wsg" in qmodel)
    rng = np.random.default_rng(len(rows))
    k = len(rows)
    Qd = np.zeros((3, L.MOTION, L.MOTION))
    for b in range(3):
        A = rng.standard_normal((k, k)) * 1e-3
        Qd[b][np.ix_(rows, rows)] = A @ A.T
    Lq = ts.noise_factor(tc, t(Qd)).numpy()
    frozen = sorted(set(range(L.MOTION)) - set(rows))
    jnoise = jax.jit(js.noise_factor, static_argnums=0)
    for b in range(3):
        Lj = np.asarray(jnoise(jc, jnp.asarray(Qd[b])))
        close(Lq[b], Lj, FACTOR_TOL)
        close(ts.noise_factor(tc, t(Qd[b])), Lj, FACTOR_TOL)
        close(Lq[b] @ Lq[b].T, Qd[b], ROUNDTRIP_TOL)
        for X in (Lq[b], Lj):
            assert np.abs(X[frozen, :]).max() == 0.0
            assert np.abs(X[:, frozen]).max() == 0.0


def test_factor_propagate_matches_reference():
    jc, tc = jax_cfg(), torch_cfg()
    D = tc.dims.full
    m = L.MOTION
    rng = np.random.default_rng(5)
    rows = ts.noise_rows(tc)
    A = rng.standard_normal((D, D)) * 0.3
    S = np.pad(np.linalg.cholesky(A @ A.T + 0.1 * np.eye(D)),
               ((0, 0), (0, m + 6)))
    Phi = np.eye(m) + 0.05 * rng.standard_normal((m, m))
    Qd = np.zeros((m, m))
    B = rng.standard_normal((len(rows), len(rows))) * 1e-3
    Qd[np.ix_(rows, rows)] = B @ B.T
    Sj = np.asarray(js.factor_propagate(jc, jnp.asarray(S), jnp.asarray(Phi),
                                        jnp.asarray(Qd)))
    St = ts.factor_propagate(tc, t(S), t(Phi), t(Qd))
    assert St.shape == Sj.shape == S.shape
    close(St, Sj, FACTOR_TOL)
    # batched: each item as the single call
    Sb = ts.factor_propagate(tc, t(np.stack([S, 2 * S])),
                             t(np.stack([Phi, Phi.T])), t(np.stack([Qd, Qd])))
    close(Sb[0], Sj, FACTOR_TOL)
    close(Sb[1], ts.factor_propagate(tc, t(2 * S), t(Phi.T), t(Qd)),
          FACTOR_TOL)


def test_subfilter_update_converges_depth_as_the_reference():
    """The reference test's scene (radtan camera), exact measurement,
    wrong initial depth, 30 steps: every output of every step within
    SUBFILTER_TOL of the reference's, and each step within TABLE_TOL of a
    row of ``subfilter_update_table`` on the same inputs."""
    X, Rsbr, Tsbr, x_true, _, kind, intrin = test_jacobians.make_scene()
    Xc, _ = jf.unproject_logz(x_true)
    Xs = Rsbr @ (X.Rbc @ Xc + X.Tbc) + Tsbr
    Xb = X.Rsb.T @ (Xs - X.Tsb)
    xcn, _ = jf.project_persp(X.Rbc.T @ (Xb - X.Tbc))
    xp_meas = test_jacobians.cam_mod.project(kind, intrin, xcn)
    kw = dict(Rtri=3.5 ** 2, MH_thresh=8.991)

    tX = TMotion(*(t(f) for f in X))
    tin = [t(a) for a in (intrin, Rsbr, Tsbr)]
    jx = x_true.at[2].set(np.log(1.0))
    jP = jnp.diag(jnp.asarray([1e-4, 1e-4, 0.5]))
    tx, tP = t(jx), t(jP)
    tXt = TMotion(*(f[None] for f in tX))
    # the table's second row: the same feature with its measurement moved
    # 30 px, far enough for the MH inflation branch
    xp_far = xp_meas + 30.0
    jsub = jax.jit(jf.subfilter_update, static_argnums=0)
    any_bad = False
    for _ in range(30):
        jout = jsub(kind, intrin, X, Rsbr, Tsbr, jx, jP, xp_meas, **kw)
        jfar = jsub(kind, intrin, X, Rsbr, Tsbr, jx, jP, xp_far, **kw)
        tout = tf.subfilter_update(kind, tin[0], tX, tin[1], tin[2], tx, tP,
                                   t(xp_meas), **kw)
        tab = tf.subfilter_update_table(
            kind, tin[0], tXt, torch.stack([tin[1], tin[1]]),
            torch.stack([tin[2], tin[2]]), torch.stack([tx, tx]),
            torch.stack([tP, tP]), t(np.stack([xp_meas, xp_far])), **kw)
        for a, b, c, d in zip(tout, jout, tab, jfar):
            assert a.shape == np.shape(b)
            close(a, b, SUBFILTER_TOL)
            close(c[0], a, TABLE_TOL)
            close(c[1], d, SUBFILTER_TOL)
        any_bad |= bool(tab[3][1])
        jx, jP = jout[0], jout[1]
        tx, tP = tout[0], tout[1]
    err0 = abs(np.log(1.0) - float(x_true[2]))
    assert abs(float(tx[2]) - float(x_true[2])) < 0.7 * err0
    assert float(tP[2, 2]) < 0.5
    assert any_bad      # the MH inflation branch ran
