"""Parity of the port's four camera models with the JAX package, in
float64 on the CPU, plus the cases of tests/test_cam.py run through the
port.

``project``, both Jacobians of ``project_with_jac`` (the reference takes
them with ``jax.jacfwd``, the port writes them out) and ``unproject`` at
15 and 3 Newton steps agree within 1e-12 on tests/test_cam.py's fixtures:
on 32 random points, and on the points where a model switches to its
constant branch (the principal point; atan's radius just below and above
1e-4, equidistant's just below and above 1e-8), where the distortion
columns of the intrinsics Jacobian are 0 and ``dxp_dxc`` is diag(fx, fy).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_cam import FIXTURES
from xivo_tpu import cam as jcam
from xivo_tpu_torch.cam import models as tcam

torch.set_num_threads(2)
TOL = 1e-12
NAMES = {tcam.PINHOLE: "pinhole", tcam.ATAN: "atan",
         tcam.EQUIDISTANT: "equidistant", tcam.RADTAN: "radtan"}
KINDS = sorted(FIXTURES)


def t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def close(a, b, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=tol, err_msg=msg)


def _ring(r, n=8):
    ang = np.linspace(0.1, 2 * np.pi + 0.1, n, endpoint=False)
    return np.stack([r * np.cos(ang), r * np.sin(ang)], axis=1)


def points(kind):
    """32 random points, the principal point and the radii around the
    model's switch to its constant branch."""
    rng = np.random.default_rng(11 + kind)
    pts = [rng.uniform(-0.5, 0.5, (32, 2)), np.zeros((1, 2)),
           _ring(1e-3), _ring(1e-12)]
    if kind == tcam.ATAN:
        pts += [_ring(1e-4 * (1 - 1e-6)), _ring(1e-4 * (1 + 1e-6))]
    if kind == tcam.EQUIDISTANT:
        pts += [_ring(1e-8 * (1 - 1e-6)), _ring(1e-8 * (1 + 1e-6))]
    return np.concatenate(pts)


def reference(kind):
    _, ji, _ = jcam.intrinsics_from_cfg(FIXTURES[kind])
    return ji


@pytest.mark.parametrize("kind", KINDS, ids=lambda k: NAMES[k])
def test_intrinsics_from_cfg_matches_reference(kind):
    k, ti, shape = tcam.intrinsics_from_cfg(FIXTURES[kind])
    kj, ji, shape_j = jcam.intrinsics_from_cfg(FIXTURES[kind])
    assert (k, shape) == (kj, shape_j) and ti.dtype == torch.float64
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("kind", KINDS, ids=lambda k: NAMES[k])
def test_project_and_jacobians_match_reference(kind):
    ji = reference(kind)
    _, ti, _ = tcam.intrinsics_from_cfg(FIXTURES[kind])
    xc = points(kind)
    jxp, jdx, jdp = jax.vmap(
        lambda v: jcam.project_with_jac(kind, ji, v))(jnp.asarray(xc))
    txp, tdx, tdp = tcam.project_with_jac(kind, ti, t(xc))
    close(txp, jxp, msg="xp")
    close(tdx, jdx, msg="dxp_dxc")
    close(tdp, jdp, msg="dxp_dintrin")
    close(tcam.project(kind, ti, t(xc)), jxp, msg="project")
    # past the model's DIM the intrinsics Jacobian is exactly 0
    dim = tcam.MODEL_DIM[kind]
    assert not tdp[..., dim:].any()
    # at the principal point the lens is the identity
    fx, fy = FIXTURES[kind]["fx"], FIXTURES[kind]["fy"]
    np.testing.assert_array_equal(tdx[32].numpy(), np.diag([fx, fy]))
    assert not tdp[32, :, 4:].any()


@pytest.mark.parametrize("iters", [15, 3])
@pytest.mark.parametrize("kind", KINDS, ids=lambda k: NAMES[k])
def test_unproject_matches_reference(kind, iters):
    ji = reference(kind)
    _, ti, _ = tcam.intrinsics_from_cfg(FIXTURES[kind])
    xp = np.asarray(jax.vmap(lambda v: jcam.project(kind, ji, v))(
        jnp.asarray(points(kind))))
    want = jax.vmap(lambda v: jcam.unproject(kind, ji, v, iters=iters))(
        jnp.asarray(xp))
    close(tcam.unproject(kind, ti, t(xp), iters=iters), want)


@pytest.mark.parametrize("kind", KINDS, ids=lambda k: NAMES[k])
def test_functions_broadcast_over_leading_dims(kind):
    """The filter's calls: intrinsics (B, 1, 9) or (B, 1, 1, 9) against
    points (B, F, 2) or (B, F, K, 2), each batch item with its own lens."""
    _, ti, _ = tcam.intrinsics_from_cfg(FIXTURES[kind])
    rng = np.random.default_rng(3)
    intrin = ti * (1 + 1e-3 * t(rng.standard_normal((3, 9))))
    xc = t(rng.uniform(-0.4, 0.4, (3, 5, 4, 2)))
    xp, dx, dp = tcam.project_with_jac(kind, intrin[:, None, None], xc)
    assert xp.shape == (3, 5, 4, 2) and dx.shape == (3, 5, 4, 2, 2) \
        and dp.shape == (3, 5, 4, 2, 9)
    for b in range(3):
        one = tcam.project_with_jac(kind, intrin[b], xc[b])
        for got, want in zip((xp, dx, dp), one):
            torch.testing.assert_close(got[b], want, rtol=0, atol=0)
    back = tcam.unproject(kind, intrin[:, None], xp[:, :, 0])
    close(back, xc[:, :, 0], 1e-9)


# tests/test_cam.py's four tests, through the port


@pytest.mark.parametrize("kind", KINDS, ids=lambda k: NAMES[k])
def test_roundtrip(kind):
    k, intrin, _ = tcam.intrinsics_from_cfg(FIXTURES[kind])
    assert k == kind
    rng = np.random.default_rng(1)
    xc = t(rng.uniform(-0.5, 0.5, (32, 2)))
    xc2 = tcam.unproject(kind, intrin, tcam.project(kind, intrin, xc))
    assert np.allclose(xc2, xc, atol=1e-8), float((xc2 - xc).abs().max())


@pytest.mark.parametrize("kind", KINDS, ids=lambda k: NAMES[k])
def test_jacobians_fd(kind):
    _, intrin, _ = tcam.intrinsics_from_cfg(FIXTURES[kind])
    xc = t([0.21, -0.34])
    _, dxc, dp = tcam.project_with_jac(kind, intrin, xc)
    eps = 1e-7
    for i in range(2):
        d = torch.zeros(2, dtype=torch.float64)
        d[i] = eps
        num = (tcam.project(kind, intrin, xc + d)
               - tcam.project(kind, intrin, xc - d)) / (2 * eps)
        assert np.allclose(dxc[:, i], num, atol=1e-6)
    dim = tcam.MODEL_DIM[kind]
    for i in range(dim):
        d = torch.zeros(tcam.MAX_INTRINSICS, dtype=torch.float64)
        d[i] = eps
        num = (tcam.project(kind, intrin + d, xc)
               - tcam.project(kind, intrin - d, xc)) / (2 * eps)
        assert np.allclose(dp[:, i], num, atol=1e-5)
    # parameters beyond the model DIM are inert
    assert np.allclose(dp[:, dim:], 0.0)


def test_pinhole_exact():
    _, intrin, _ = tcam.intrinsics_from_cfg(FIXTURES[tcam.PINHOLE])
    xp = tcam.project(tcam.PINHOLE, intrin, t([0.1, -0.2]))
    assert np.allclose(xp, [275.0 * 0.1 + 319.5, 274.0 * -0.2 + 239.5])


def test_radtan_distortion_direction():
    # negative k1 pulls points toward the center (barrel distortion)
    _, intrin, _ = tcam.intrinsics_from_cfg(FIXTURES[tcam.RADTAN])
    xp = tcam.project(tcam.RADTAN, intrin, t([0.4, 0.0]))
    assert xp[0] < 275.0 * 0.4 + 319.5
