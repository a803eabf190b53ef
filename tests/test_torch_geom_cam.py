"""Parity of the port's SO(3) calculus and pinhole camera with the JAX
package, in float64 on the CPU (tolerance 1e-12 unless stated: the same
closed forms evaluated in another order), plus the cases of
tests/test_geom.py and tests/test_cam.py run through the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xivo_tpu import cam as jcam
from xivo_tpu.geom import so3 as jso3
from xivo_tpu_torch.cam import models as tcam
from xivo_tpu_torch.geom import so3 as tso3

torch.set_num_threads(2)
RNG = np.random.default_rng(0)
TOL = 1e-12


def t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=tol)


@pytest.mark.parametrize("scale", [1e-10, 1e-6, 1e-2, 1.0, 3.0])
def test_so3_exp_log_match_reference(scale):
    w = RNG.standard_normal((16, 3)) * scale
    close(tso3.exp(t(w)), jso3.exp(jnp.asarray(w)))
    R = np.asarray(jso3.exp(jnp.asarray(w)))
    close(tso3.log(t(R)), jso3.log(jnp.asarray(R)), 1e-10)
    close(tso3.right_jacobian(t(w)), jso3.right_jacobian(jnp.asarray(w)))


def test_so3_log_near_pi():
    axis = np.array([1.0, 2.0, -0.5])
    axis /= np.linalg.norm(axis)
    for ang in [np.pi - 1e-7, np.pi - 1e-3, 3.1, np.pi]:
        R = np.asarray(jso3.exp(jnp.asarray(axis * ang)))
        w2 = tso3.log(t(R))
        close(tso3.exp(w2), R, 1e-8)
        close(w2, jso3.log(jnp.asarray(R)), 1e-8)


def test_so3_hat_vee_project_helpers():
    w = RNG.standard_normal(3)
    W = tso3.hat(t(w))
    close(W, jso3.hat(jnp.asarray(w)))
    close(tso3.vee(W), w)
    R = np.asarray(jso3.exp(jnp.asarray(w))) + 1e-4 * RNG.standard_normal(
        (3, 3))
    close(tso3.project(t(R)), jso3.project(jnp.asarray(R)))
    A, B = RNG.standard_normal((3, 3)), RNG.standard_normal((3, 3))
    close(tso3.dAB_dA(t(B), 3, 3), jso3.dAB_dA(jnp.asarray(B), 3, 3))
    close(tso3.dAB_dB(t(A), 3, 3), jso3.dAB_dB(jnp.asarray(A), 3, 3))
    close(tso3.dA_dAu(torch.float64), jso3.dA_dAu(jnp.float64))
    u = RNG.standard_normal(6)
    close(tso3.upper_tri_from6(t(u)), jso3.upper_tri_from6(jnp.asarray(u)))


PIN = dict(model="pinhole", rows=480, cols=640, fx=275.0, fy=274.0,
           cx=319.5, cy=239.5)


def test_pinhole_matches_reference():
    _, ji, _ = jcam.intrinsics_from_cfg(PIN)
    kind, ti, _ = tcam.intrinsics_from_cfg(PIN)
    close(ti, ji)
    xc = RNG.uniform(-0.5, 0.5, (32, 2))
    jxp, jdx, jdp = jax.vmap(
        lambda v: jcam.project_with_jac(kind, ji, v))(jnp.asarray(xc))
    txp, tdx, tdp = tcam.project_with_jac(kind, ti, t(xc))
    close(txp, jxp)
    close(tdx, jdx)
    close(tdp, jdp)
    close(tcam.unproject(kind, ti, txp), xc, 1e-12)
    close(tcam.project(kind, ti, t([0.1, -0.2])),
          [275.0 * 0.1 + 319.5, 274.0 * -0.2 + 239.5])


def test_other_camera_models_not_ported_yet():
    with pytest.raises(NotImplementedError, match="ROADMAP A.12"):
        tcam.intrinsics_from_cfg(dict(PIN, model="radtan"))
