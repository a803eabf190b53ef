"""Parity of the port's fast propagation, feature geometry and update
building blocks with the JAX package, float64 on the CPU (tolerance
1e-10 absolute unless stated), plus the finite-difference check of
tests/test_jacobians.py::test_instate_jacobian_fd through the port (with
the pinhole camera, the one model ported)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xivo_tpu.filter import features as jf
from xivo_tpu.filter import propagate as jp
from xivo_tpu.filter.state import MotionState as JMotion
from xivo_tpu.geom import so3 as jso3
from xivo_tpu_torch.filter import features as tf
from xivo_tpu_torch.filter import layout as L
from xivo_tpu_torch.filter import propagate as tp
from xivo_tpu_torch.filter.retraction import (apply_group_error,
                                              apply_motion_error)
from xivo_tpu_torch.filter.state import MotionState as TMotion

from test_torch_pipeline import jax_cfg, torch_cfg

torch.set_num_threads(2)
TOL = 1e-10
RNG = np.random.default_rng(7)
INTRIN = np.array([300.0, 295.0, 320.0, 240.0, 0, 0, 0, 0, 0])


def t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=tol)


def motion(n):
    """n random motion states as (JAX per-item list, port batched)."""
    def r(*s, sc=1.0):
        return RNG.standard_normal((n,) + s) * sc
    f = dict(
        Rsb=np.asarray(jso3.exp(jnp.asarray(r(3, sc=0.4)))), Tsb=r(3),
        Vsb=r(3), bg=0.02 * r(3), ba=0.05 * r(3),
        Rbc=np.asarray(jso3.exp(jnp.asarray(np.array([-1.4, 0.1, 0.05])
                                            + r(3, sc=0.01)))),
        Tbc=0.05 * r(3),
        Rsg=np.asarray(jso3.exp(jnp.asarray(r(3, sc=0.01)))),
        td=np.full(n, 0.004), Cg=np.eye(3) + 0.01 * r(3, 3),
        Ca=np.triu(np.eye(3) + 0.01 * r(3, 3)))
    jx = [JMotion(**{k: jnp.asarray(v[i]) for k, v in f.items()})
          for i in range(n)]
    return jx, TMotion(**{k: t(v) for k, v in f.items()})


def test_fast_propagation_interval_matches_reference():
    cfg_j, cfg_t = jax_cfg(), torch_cfg()
    B = 3
    jx, tx = motion(B)
    gy, ac = RNG.standard_normal((B, 3)) * 0.3, RNG.standard_normal((B, 3))
    sg, sa = RNG.standard_normal((B, 3)), RNG.standard_normal((B, 3))
    dt = np.array([0.01, 0.0033, 0.0])
    Xt, Phit, Qt = tp.propagate_interval_fast_static(
        cfg_t, tx, t(gy), t(ac), t(sg), t(sa), t(dt))
    for i in range(B):
        Xj, Phij, Qj = jp.propagate_interval_fast_static(
            cfg_j, jx[i], jnp.asarray(gy[i]), jnp.asarray(ac[i]),
            jnp.asarray(sg[i]), jnp.asarray(sa[i]), jnp.asarray(dt[i]))
        close(Phit[i], Phij)
        close(Qt[i], Qj, 1e-14)
        for k in JMotion._fields:
            close(getattr(Xt, k)[i], getattr(Xj, k))


def test_propagate_frame_matches_reference():
    """X, Phi and Qd of one frame, seen through the propagated factor."""
    from xivo_tpu.filter.pipeline import propagate_frame as jpf
    from xivo_tpu.filter.state import init_state
    from xivo_tpu_torch.filter.pipeline import propagate_frame as tpf
    from xivo_tpu_torch.interop import state_from_numpy
    cfg_j, cfg_t = jax_cfg(), torch_cfg()
    s = init_state(cfg_j)
    s = s._replace(last_gyro=jnp.asarray([0.01, -0.02, 0.03]),
                   last_accel=jnp.asarray([0.1, 9.7, 0.2]),
                   X=s.X._replace(Vsb=jnp.asarray([0.2, -0.1, 0.05])))
    gy = RNG.standard_normal((6, 3)) * 0.1
    ac = np.array([0.0, 9.8, 0.0]) + RNG.standard_normal((6, 3)) * 0.1
    idt = np.array([0.01, 0.01, 0.0096, 0.01, 0.0, 0.0])
    sj = jpf(cfg_j, s, jnp.asarray(gy), jnp.asarray(ac), jnp.asarray(idt),
             jnp.asarray(0.004))
    sb = jax.tree.map(lambda x: np.asarray(x)[None], s)
    st = tpf(cfg_t, state_from_numpy(sb, "cpu"), t(gy)[None], t(ac)[None],
             t(idt)[None], t([0.004]))
    for k in JMotion._fields:
        close(getattr(st.X, k)[0], getattr(sj.X, k))
    close(st.P[0] @ st.P[0].T, np.asarray(sj.P) @ np.asarray(sj.P).T, 1e-12)
    close(st.P[0], sj.P)
    for k in ("last_gyro", "last_accel", "slope_gyro", "slope_accel"):
        close(getattr(st, k)[0], getattr(sj, k))


def scene(n):
    jx, tx = motion(n)
    Rsbr = np.asarray(jso3.exp(jnp.asarray(RNG.standard_normal((n, 3)) * .3)))
    Tsbr = np.asarray(tx.Tsb) + 0.3 * RNG.standard_normal((n, 3))
    x = np.stack([RNG.uniform(-0.3, 0.3, n), RNG.uniform(-0.3, 0.3, n),
                  np.log(RNG.uniform(1.0, 4.0, n))], 1)
    gyro = RNG.standard_normal((n, 3)) * 0.5
    return jx, tx, Rsbr, Tsbr, x, gyro


def test_feature_geometry_matches_reference():
    n = 6
    jx, tx, Rsbr, Tsbr, x, gyro = scene(n)
    xp = RNG.uniform(100, 500, (n, 2))
    Psub = RNG.standard_normal((n, 3, 3)) * 0.1
    Psub = Psub @ Psub.transpose(0, 2, 1) + 1e-3 * np.eye(3)
    ji = jnp.asarray(INTRIN)
    tr = tf.compute_jacobian(0, t(INTRIN), tx, t(Rsbr), t(Tsbr), t(x), t(xp),
                             t(gyro), True)
    tsub = tf.subfilter_update_table(0, t(INTRIN), tx, t(Rsbr), t(Tsbr), t(x),
                                     t(Psub), t(xp), 3.5 ** 2, 8.991)
    tpred = tf.predict_pixel(0, t(INTRIN), tx, t(Rsbr), t(Tsbr), t(x))
    Rn = np.asarray(jso3.exp(jnp.asarray(RNG.standard_normal((n, 3)) * .2)))
    Tn = Tsbr + RNG.standard_normal((n, 3)) * 0.2
    tco = tf.change_owner(tx, t(Rsbr), t(Tsbr), t(Rn), t(Tn), t(x), t(Psub))
    for i in range(n):
        jr = jf.compute_jacobian(0, ji, jx[i], jnp.asarray(Rsbr[i]),
                                 jnp.asarray(Tsbr[i]), jnp.asarray(x[i]),
                                 jnp.asarray(xp[i]), jnp.asarray(gyro[i]),
                                 True)
        for k in jr._fields:
            close(getattr(tr, k)[i], getattr(jr, k), 1e-8)
        jp_, jz = jf.predict_pixel(0, ji, jx[i], jnp.asarray(Rsbr[i]),
                                   jnp.asarray(Tsbr[i]), jnp.asarray(x[i]))
        close(tpred[0][i], jp_, 1e-9)
        close(tpred[1][i], jz)
        jco = jf.change_owner(jx[i], jnp.asarray(Rsbr[i]),
                              jnp.asarray(Tsbr[i]), jnp.asarray(Rn[i]),
                              jnp.asarray(Tn[i]), jnp.asarray(x[i]),
                              jnp.asarray(Psub[i]))
        for a, b in zip(tco, jco):
            close(a[i], b)
    # the table form with one motion state for every row
    jsub = jf.subfilter_update_table(
        0, ji, jx[0], jnp.asarray(Rsbr), jnp.asarray(Tsbr),
        jnp.asarray(x), jnp.asarray(Psub), jnp.asarray(xp), 3.5 ** 2, 8.991)
    tsub0 = tf.subfilter_update_table(
        0, t(INTRIN), TMotion(*(f[:1] for f in tx)), t(Rsbr), t(Tsbr), t(x),
        t(Psub), t(xp), 3.5 ** 2, 8.991)
    for a, b in zip(tsub0, jsub):
        close(a, b, 1e-9)
    assert tsub[0].shape == (n, 3)


@pytest.mark.parametrize("method", ["dlt_avg", "dlt_svd", "l1_angular",
                                    "l2_angular", "linf_angular"])
def test_triangulation_matches_reference(method):
    Xc1 = np.array([0.3, -0.2, 2.0])
    R12 = np.asarray(jso3.exp(jnp.asarray([0.02, 0.3, -0.01])))
    T12 = np.array([0.5, 0.05, 0.1])
    Xc2 = R12.T @ (Xc1 - T12)
    xc1, xc2 = Xc1[:2] / Xc1[2], Xc2[:2] / Xc2[2]
    out = tf.triangulate_two_view(t(R12), t(T12), t(xc1), t(xc2), method)
    close(out, Xc1, 1e-7)
    Xo, ok = tf.triangulate_two_view_checked(
        t(R12), t(T12), t(xc1), t(xc2), method, 0.1 * np.pi / 180,
        0.25 * np.pi / 180)
    Xj, okj = jf.triangulate_two_view_checked(
        jnp.asarray(R12), jnp.asarray(T12), jnp.asarray(xc1),
        jnp.asarray(xc2), method, 0.1 * np.pi / 180, 0.25 * np.pi / 180)
    close(Xo, Xj, 1e-9)
    assert bool(ok) == bool(okj)


def test_instate_jacobian_fd():
    """FD through the port's own retraction (pinhole camera)."""
    _, tx, Rsbr, Tsbr, x, gyro = scene(1)
    X = TMotion(*(f[0] for f in tx))
    Rsbr, Tsbr, x, gyro = t(Rsbr[0]), t(Tsbr[0]), t(x[0]), t(gyro[0])
    intrin = t(INTRIN)
    td0 = X.td
    w0 = tp.mv(X.Cg, gyro) - X.bg

    def measure(X, Rr, Tr, x, intrin):
        w = tp.mv(X.Cg, gyro) - X.bg
        from xivo_tpu_torch.geom import so3
        Rsb_eff = X.Rsb @ so3.exp(w * X.td - w0 * td0)
        Tsb_eff = X.Tsb + X.Vsb * (X.td - td0)
        Xc, _ = tf.unproject_logz(x)
        Xs = tp.mv(Rr, tp.mv(X.Rbc, Xc) + X.Tbc) + Tr
        Xb = tp.mv(Rsb_eff.T, Xs - Tsb_eff)
        Xcn = tp.mv(X.Rbc.T, Xb - X.Tbc)
        xcn, _ = tf.project_persp(Xcn)
        return intrin[:2] * xcn + intrin[2:4]

    xp = measure(X, Rsbr, Tsbr, x, intrin)
    row = tf.compute_jacobian(0, intrin, X, Rsbr, Tsbr, x, xp, gyro, True)
    close(row.inn, 0.0, 1e-10)
    eps = 1e-6
    for off, n in [(L.WSB, 3), (L.TSB, 3), (L.WBC, 3), (L.TBC, 3), (L.TD, 1),
                   (L.CG, 9), (L.BG, 3)]:
        for i in range(n):
            e = torch.zeros(L.MOTION, dtype=torch.float64)
            e[off + i] = eps
            num = (measure(apply_motion_error(X, e), Rsbr, Tsbr, x, intrin)
                   - measure(apply_motion_error(X, -e), Rsbr, Tsbr, x,
                             intrin)) / (2 * eps)
            close(row.J_motion[:, off + i], num, 2e-4)
    for i in range(6):
        e = torch.zeros(6, dtype=torch.float64)
        e[i] = eps
        num = (measure(X, *apply_group_error(Rsbr, Tsbr, e), x, intrin)
               - measure(X, *apply_group_error(Rsbr, Tsbr, -e), x, intrin)
               ) / (2 * eps)
        close(row.J_group[:, i], num, 2e-4)
    for i in range(3):
        e = torch.zeros(3, dtype=torch.float64)
        e[i] = eps
        num = (measure(X, Rsbr, Tsbr, x + e, intrin)
               - measure(X, Rsbr, Tsbr, x - e, intrin)) / (2 * eps)
        close(row.J_feat[:, i], num, 2e-4)
    for i in range(4):
        e = torch.zeros(9, dtype=torch.float64)
        e[i] = eps
        num = (measure(X, Rsbr, Tsbr, x, intrin + e)
               - measure(X, Rsbr, Tsbr, x, intrin - e)) / (2 * eps)
        close(row.J_cam[:, i], num, 1e-4)
