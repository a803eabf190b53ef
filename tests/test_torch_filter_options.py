"""The other filter options' building blocks against the JAX package, on
the CPU in float64, within 1e-10:

* ``huber_robustify_R`` (``filter/update.py``) on innovations some of
  which pass the threshold;
* ``oc_correct_phi`` (``filter/propagate.py``) on random transitions,
  and the constraint it enforces, Phi u = R_new^T g on the W rows;
* ``oc_nullspace`` and ``oc_project_rows`` on a live state (groups in
  the window), for the stacked Jacobian and for random rows of an OOS
  stack's shape: H N = 0 after the projection;
* ``refine_depth`` (``filter/refine.py``) on every feature row of the live
  state, with ``use_hessian`` off and on: x and the acceptance everywhere,
  the inverse Hessian on the features with two or more observations (the
  rank-2 Hessian of a single observation keeps the subfilter covariance
  in the port, where the reference takes ``pinv``: ROADMAP C);
* ``_one_pt_ransac`` (``filter/pipeline.py``) on the live state as it is
  (every innovation low: the inlier set is kept) and with the pose moved
  10 cm while its covariance is inflated and one gross outlier is planted
  (the rescue branch: high-innovation features rescued, the outlier
  rejected): the final and rejected slots equal;
* the initial intrinsics stds of ``online_camera_calib`` in both
  covariance forms, for the pinhole and the equidistant model;
* ``init_cov``'s observation blocks with the intrinsics columns, on the
  live state's instate rows.

The live state: 12 frames of two PCW sequences at the tiny Dims with every
option on (``sim.configs.OPTIONS``), run by the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_pipeline import TINY, plain
from xivo_tpu.filter import init_cov as jic
from xivo_tpu.filter import pipeline as jpl
from xivo_tpu.filter import propagate as jprop
from xivo_tpu.filter import update as jup
from xivo_tpu.filter.config import config_from_json as jax_config_from_json
from xivo_tpu.filter.layout import Dims as JaxDims
from xivo_tpu.filter.refine import refine_depth as jax_refine_depth
from xivo_tpu.filter.state import init_state as jax_init_state
from xivo_tpu_torch import interop
from xivo_tpu_torch.cam import models as cam_mod
from xivo_tpu_torch.filter import init_cov as tic
from xivo_tpu_torch.filter import layout as L
from xivo_tpu_torch.filter import pipeline as tpl
from xivo_tpu_torch.filter import propagate as tprop
from xivo_tpu_torch.filter import update as tup
from xivo_tpu_torch.filter.config import config_from_json
from xivo_tpu_torch.filter.layout import Dims
from xivo_tpu_torch.filter.refine import refine_depth
from xivo_tpu_torch.filter.state import init_state
from xivo_tpu_torch.ops.dense import take_rows
from xivo_tpu_torch.runner import batch_states, make_batch_runner
from xivo_tpu_torch.sim.configs import (EQUIDISTANT_512_CAM, OPTIONS,
                                        PCW_CALIB_CFG)
from xivo_tpu_torch.sim.stream import build_pcw_stream

torch.set_num_threads(2)
TOL = 1e-10
KW = dict(dtype="float64", sim_initialize_depths=True,
          propagation_mode="fast", covariance_form="sqrt", **OPTIONS)


def cfgs(world=PCW_CALIB_CFG, **over):
    kw = dict(KW, **over)
    jc = jax_config_from_json(world, dims=JaxDims(*TINY), **kw)
    tc = config_from_json(world, dims=Dims(*TINY), **kw)
    assert plain(jc) == plain(tc)
    return jc, tc


@pytest.fixture(scope="module")
def live():
    jc, tc = cfgs()
    fi, gt = build_pcw_stream(tc, seed=1, total_time=0.6, noise_px=0.25)
    s = batch_states(tc, 2, device="cpu")
    s = s._replace(last_gyro=torch.tensor(gt["gyro0"]).expand(2, 3),
                   last_accel=torch.tensor(gt["accel0"]).expand(2, 3))
    s, _ = make_batch_runner(tc)(s, type(fi)(*(np.stack([a, a])
                                               for a in fi)))
    assert int((s.f2row >= 0).sum()) > 8 and int((s.g2row >= 0).sum()) > 2
    return jc, tc, s


def jstate(s):
    """The port's state as the reference's functions take it (jnp leaves)."""
    return jax.tree.map(jnp.asarray, interop.state_to_numpy(s))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def test_huber_robustify_R():
    rng = np.random.default_rng(0)
    inn = rng.standard_normal((3, 16)) * 2.0
    want = jax.vmap(lambda i: jup.huber_robustify_R(i, 1.0, 1.1,
                                                    jnp.float64))(inn)
    got = tup.huber_robustify_R(torch.from_numpy(inn), 1.0, 1.1,
                                torch.float64)
    close(got, want)
    assert (got > 1.0).any() and (got == 1.0).any()


def test_oc_correct_phi(live):
    jc, tc, s = live
    rng = np.random.default_rng(1)
    B, m = 2, L.MOTION
    Phi = np.eye(m) + rng.standard_normal((B, m, m)) * 0.05
    Xn = interop.state_to_numpy(s).X
    prev = [rng.standard_normal((B, 3)) * 0.1 for _ in range(2)]
    want = jax.vmap(lambda P, X, R, V, T, Rsg: jprop.oc_correct_phi(
        jc, P, X, R, V, T, Rsg))(
        Phi, jax.tree.map(jnp.asarray, Xn), Xn.Rsb, Xn.Vsb + prev[0],
        Xn.Tsb + prev[1], Xn.Rsg)
    X = s.X
    got = tprop.oc_correct_phi(
        tc, torch.from_numpy(Phi), X, X.Rsb, X.Vsb + torch.from_numpy(
            prev[0]), X.Tsb + torch.from_numpy(prev[1]), X.Rsg)
    close(got, want)
    ghat = -X.Rsg[:, :, 2]                     # Rsg (0, 0, -9.8) / 9.8
    u = (X.Rsb.transpose(-1, -2) @ ghat[..., None])[..., 0]
    Wu = (got[:, :3, :3] @ u[..., None])[..., 0]
    torch.testing.assert_close(Wu, u, rtol=0, atol=1e-12)
    assert float((got - torch.from_numpy(Phi)).abs().max()) > 1e-6


def test_oc_nullspace_and_projection(live):
    jc, tc, s = live
    js = jstate(s)
    want_N = jax.vmap(lambda s: jup.oc_nullspace(jc, s))(js)
    N = tup.oc_nullspace(tc, s)
    close(N, want_N)
    raw = tup.build_stacked_jacobian(
        dataclasses.replace(tc, use_oc_meas=False), s).H
    rng = np.random.default_rng(2)
    oos_rows = torch.from_numpy(rng.standard_normal((2, 40, tc.dims.full)))
    for H in (raw, oos_rows):
        want = jax.vmap(jup.oc_project_rows)(jnp.asarray(H.numpy()), want_N)
        got = tup.oc_project_rows(H, N)
        close(got, want)
        scale = float(H.abs().max())
        assert float((got @ N).abs().max()) < 1e-9 * scale
    # the random rows leave the observable subspace: the projection moves
    # them (the state's own rows, at first-estimate poses, already have
    # H N ~ 0 this early)
    assert float((got - oos_rows).abs().max()) > 1e-3
    # build_stacked_jacobian with use_oc_meas is the projection of the raw H
    close(tup.build_stacked_jacobian(tc, s).H,
          np.asarray(jax.vmap(jup.oc_project_rows)(
              jnp.asarray(raw.numpy()), want_N)))


def _refine_inputs(s):
    fr, gr = s.features, s.groups
    NG = gr.gid.shape[-1]
    grow = torch.clamp(fr.ref, 0, NG - 1)
    obs = fr.adj & ~tpl._onehot_rows(grow, NG) & gr.active[:, None, :]
    return (s.cam, s.X, take_rows(gr.Rsb, grow), take_rows(gr.Tsb, grow),
            gr.Rsb, gr.Tsb, obs, fr.adj_xp, fr.x, fr.Psub)


@pytest.mark.parametrize("use_hessian", [False, True])
def test_refine_depth(live, use_hessian):
    jc, tc, s = live
    opts = dataclasses.replace(tc.refinement, use_hessian=use_hessian)
    args = _refine_inputs(s)
    x, Psub, ok = refine_depth(0, *args, opts)
    jargs = [jax.tree.map(lambda t: jnp.asarray(t.numpy()), a) for a in args]
    one = jax.vmap(lambda Rr, Tr, om, oxp, x0, P0, cam, X, GR, GT:
                   jax_refine_depth(0, cam, X, Rr, Tr, GR, GT, om, oxp, x0,
                                    P0, opts),
                   in_axes=(0, 0, 0, 0, 0, 0, None, None, None, None))
    jx, jP, jok = jax.vmap(one)(*jargs[2:4], *jargs[6:], jargs[0],
                                jargs[1], *jargs[4:6])
    close(x, jx)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    n_obs = args[6].sum(-1)
    multi = n_obs >= 2
    assert int((ok & multi).sum()) >= 4, (ok, n_obs)
    close(Psub[multi], np.asarray(jP)[multi.numpy()])
    if use_hessian:
        assert float((Psub - args[9])[multi].abs().max()) > 0
        single = n_obs == 1
        torch.testing.assert_close(Psub[single], args[9][single], rtol=0,
                                   atol=0)
    else:
        torch.testing.assert_close(Psub, args[9], rtol=0, atol=0)


def _rescue_state(tc, s):
    """The live state with the pose 10 cm off, its covariance rows
    inflated 30 x, and one gross outlier planted in each sequence."""
    P = s.P.clone()
    P[:, L.TSB:L.TSB + 3] *= 30.0
    X = s.X._replace(Tsb=s.X.Tsb + torch.tensor([0.1, 0.03, 0.0],
                                                dtype=torch.float64))
    xp = s.features.xp.clone()
    for b in range(2):
        xp[b, s.f2row[b, 0]] += torch.tensor([15.0, -9.0],
                                             dtype=torch.float64)
    return s._replace(P=P, X=X, features=s.features._replace(xp=xp))


@pytest.mark.parametrize("branch", ["all_low", "rescue"])
def test_one_pt_ransac(live, branch):
    jc, tc, s = live
    if branch == "rescue":
        s = _rescue_state(tc, s)
    sj = tup.build_stacked_jacobian(tc, s)
    inl = sj.valid
    final, rejected = tpl._one_pt_ransac(tc, s, inl)
    _, jfinal, jrej = jax.jit(jax.vmap(
        lambda s, m: jpl._one_pt_ransac(jc, s, m)))(
        jstate(s), jnp.asarray(inl.numpy()))
    np.testing.assert_array_equal(final.numpy(), np.asarray(jfinal))
    np.testing.assert_array_equal(rejected.numpy(), np.asarray(jrej))
    res = sj.inn.reshape(2, -1, 2).norm(dim=-1)
    hi = inl & (res >= tc.ransac_thresh)
    if branch == "all_low":
        assert not hi.any() and torch.equal(final, inl)
        assert not rejected.any()
    else:
        assert int((final & hi).sum(-1).min()) >= 1      # rescued
        assert int(rejected.sum(-1).min()) >= 1          # the outlier
        assert torch.equal(rejected, inl & ~final)


@pytest.mark.parametrize("form", ["sqrt", "full"])
@pytest.mark.parametrize("camera", ["pinhole", "equidistant"])
def test_camera_calibration_initial_stds(form, camera):
    world = dict(PCW_CALIB_CFG)
    if camera == "equidistant":
        world["camera_cfg"] = EQUIDISTANT_512_CAM
    over = dict(covariance_form=form)
    if form == "full":
        over["propagation_mode"] = "reference"
        over["use_oc"] = False
    jc, tc = cfgs(world, **over)
    want = np.asarray(jax_init_state(jc).P)
    got = init_state(tc, device="cpu").P.numpy()
    np.testing.assert_array_equal(got, want)
    dim = cam_mod.MODEL_DIM[cam_mod.MODEL_IDS[tc.cam_model]]
    diag = np.diagonal(got)[L.CAM:L.CAM + L.NCAM]
    assert (diag[:dim] > 0).all() and (diag[dim:] == 0).all()


def test_init_cov_intrinsics_blocks(live):
    jc, tc, s = live
    rows = s.f2row
    N, M = tic._obs_blocks_batched(tc, s, rows)
    jN, jM = jax.jit(jax.vmap(
        lambda s, r: jic._obs_blocks_batched(jc, s, r)))(
        jstate(s), jnp.asarray(rows.numpy()))
    close(N, jN)
    close(M, jM)
    cam = M[..., 6:6 + L.NCAM]
    assert float(cam.abs().max()) > 0
    # off, the intrinsics columns are zero and the rest unchanged
    N0, M0 = tic._obs_blocks_batched(
        dataclasses.replace(tc, online_camera_calib=False), s, rows)
    torch.testing.assert_close(N0, N, rtol=0, atol=0)
    assert float(M0[..., 6:6 + L.NCAM].abs().max()) == 0
    torch.testing.assert_close(M0[..., :6], M[..., :6], rtol=0, atol=0)
