"""The port's homography RANSAC against the JAX package, on the CPU in
float64.

The reference draws each hypothesis' uniforms from a JAX key; the port
takes them as an argument. ``homography_draws`` rebuilds the reference's
from its key (``split(key, n_hyps)``, then ``uniform(k, (N,))`` each) and
hands them to the port. The inlier masks and ``ok`` must then be equal,
on tests/test_tracker_extras.py:180's scene (a translation plus 6 gross
outliers), on a random projective scene with invalid rows and outliers,
and on a scene with fewer valid rows than ``min_inliers`` (nothing is
rejected). The port's DLT solves a normalized 8 x 8 system where the
reference takes an SVD (see ``frontend/homography.py``): the homographies
agree to rounding, far from the 3 px threshold on these scenes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xivo_tpu.filter.config import config_from_json as jax_config_from_json
from xivo_tpu.filter.pipeline import tracker_pointcloud as jax_tracker_pc
from xivo_tpu.filter.state import init_state as jax_init_state
from xivo_tpu.frontend.homography import homography_ransac as jax_ransac
from xivo_tpu.sim.configs import PCW_CFG as JAX_PCW_CFG
from xivo_tpu_torch import interop
from xivo_tpu_torch.filter.config import config_from_json
from xivo_tpu_torch.filter.pipeline import tracker_pointcloud
from xivo_tpu_torch.filter.state import TS_DROPPED, TS_TRACKED
from xivo_tpu_torch.frontend.homography import N_HYPS, homography_ransac
from xivo_tpu_torch.sim.configs import PCW_CFG

torch.set_num_threads(2)


def homography_draws(key, n, dtype=jnp.float64):
    """The uniforms (N_HYPS, n) ``homography_ransac`` draws from `key`."""
    return np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (n,), dtype))(
        jax.random.split(key, N_HYPS)))


def tracker_draws(keys, n, dtype=jnp.float64):
    """The tracker's split of each sequence's key (B, 2), then its draws:
    (the next keys, draws (B, N_HYPS, n))."""
    def one(key):
        key, sub = jax.random.split(key)
        return key, jax.vmap(lambda k: jax.random.uniform(k, (n,), dtype))(
            jax.random.split(sub, N_HYPS))
    nxt, u = jax.vmap(one)(keys)
    return nxt, np.asarray(u)


def translation_scene(rng, N=60, pad=0):
    """tests/test_tracker_extras.py:180's scene: a 3 px shift with 6 gross
    outliers moved 30 px; `pad` invalid rows after the N valid ones."""
    p0 = rng.uniform(60, 420, (N, 2))
    p1 = p0 + np.array([3.0, 1.5])
    bad = rng.choice(N, 6, replace=False)
    ang = rng.uniform(0, 2 * np.pi, 6)
    p1[bad] += 30.0 * np.stack([np.cos(ang), np.sin(ang)], axis=1)
    valid = np.ones(N + pad, bool)
    valid[N:] = False
    pz = np.zeros((pad, 2))
    return np.concatenate([p0, pz]), np.concatenate([p1, pz]), valid


def projective_scene(rng, N=96):
    """A random perspective homography on 512 x 512 pixels with 0.5 px
    noise, 15 % gross outliers and a quarter of the rows invalid (their
    coordinates junk)."""
    H = np.array([[1.02, 0.03, 4.0], [-0.02, 0.98, -3.0],
                  [2e-5, -3e-5, 1.0]]) + rng.normal(0, 1e-3, (3, 3)) \
        * np.array([[1, 1, 100], [1, 1, 100], [1e-3, 1e-3, 0]])
    p0 = rng.uniform(0, 512, (N, 2))
    w = np.concatenate([p0, np.ones((N, 1))], 1) @ H.T
    p1 = w[:, :2] / w[:, 2:] + rng.normal(0, 0.5, (N, 2))
    out = rng.random(N) < 0.15
    p1[out] += rng.uniform(-60, 60, (out.sum(), 2))
    valid = rng.random(N) >= 0.25
    p1[~valid] = rng.uniform(-1e3, 1e3, ((~valid).sum(), 2))
    return p0, p1, valid


def few_valid_scene(rng, N=40):
    """Only 8 valid rows, fewer than min_inliers: nothing is rejected."""
    p0, p1, _ = translation_scene(rng, N)
    valid = np.zeros(N, bool)
    valid[rng.choice(N, 8, replace=False)] = True
    return p0, p1, valid


SCENES = {"translation": lambda r: translation_scene(r, pad=36),
          "projective": projective_scene, "few_valid": few_valid_scene}


@pytest.mark.parametrize("name", list(SCENES))
def test_homography_ransac_matches_reference_given_its_draws(name):
    rng = np.random.default_rng(7)
    scenes = [SCENES[name](rng) for _ in range(3)]
    keys = jax.random.split(jax.random.PRNGKey(3), len(scenes))
    want_inl, want_ok, draws = [], [], []
    for key, (p0, p1, valid) in zip(keys, scenes):
        inl, ok = jax_ransac(key, jnp.asarray(p0), jnp.asarray(p1),
                             jnp.asarray(valid), thresh=3.0)
        want_inl.append(np.asarray(inl))
        want_ok.append(bool(ok))
        draws.append(homography_draws(key, p0.shape[0]))
    p0, p1, valid = (torch.tensor(np.stack(a)) for a in zip(*scenes))
    inl, ok = homography_ransac(torch.tensor(np.stack(draws)), p0, p1,
                                valid, thresh=3.0)
    np.testing.assert_array_equal(inl.numpy(), np.stack(want_inl))
    np.testing.assert_array_equal(ok.numpy(), want_ok)
    if name == "few_valid":
        assert not ok.any()
        np.testing.assert_array_equal(inl.numpy(), valid.numpy())
    else:
        # the scene's outliers are rejected and most of the rest kept
        assert ok.all()
        assert int((valid & ~inl).sum()) >= 3 * 5


def test_singular_samples_score_no_inliers():
    """Draws that pick 4 collinear points give a hypothesis that scores
    0 inliers (see the module docstring of frontend/homography.py)."""
    p0 = torch.tensor([[[0.0, 0.0], [1.0, 1.0], [2.0, 2.0], [3.0, 3.0]]
                       + [[10.0 * i, 7.0 * i * i] for i in range(1, 13)]],
                      dtype=torch.float64)
    p1 = p0 + 2.0
    u = torch.rand((1, N_HYPS, 16), dtype=torch.float64,
                   generator=torch.Generator().manual_seed(0))
    u[:, :, :4] = -1.0                 # every sample: the collinear four
    valid = torch.ones((1, 16), dtype=torch.bool)
    inl, ok = homography_ransac(u, p0, p1, valid)
    assert not ok.any() and inl.all()


def _pc_cfgs():
    kw = dict(dtype="float64", do_outlier_rejection=True)
    return (jax_config_from_json(dict(JAX_PCW_CFG), **kw),
            config_from_json(dict(PCW_CFG), **kw))


def test_pointcloud_homography_rejection_drops_outliers():
    """tests/test_tracker_extras.py's case through the port's
    ``tracker_pointcloud``, against the reference's on its draws:
    corrupted measurements inconsistent with the dominant inter-frame
    homography are dropped, and the rejected count matches."""
    jc, tc = _pc_cfgs()
    rng = np.random.default_rng(4)
    N, M = 60, 256
    ids = np.arange(N, dtype=np.int32)
    xp0 = rng.uniform(60, 420, (N, 2))
    mid = np.full((M,), -1, np.int32)
    mxp = np.zeros((M, 2))
    mdep = np.full((M,), -1.0)
    mval = np.zeros((M,), bool)
    mid[:N], mxp[:N], mval[:N] = ids, xp0, True
    js = jax_init_state(jc)
    frames = [mxp]
    mxp2 = mxp.copy()
    mxp2[:N] = xp0 + np.array([3.0, 1.5])
    bad = rng.choice(N, 6, replace=False)
    ang = rng.uniform(0, 2 * np.pi, 6)
    mxp2[bad] += 30.0 * np.stack([np.cos(ang), np.sin(ang)], axis=1)
    frames.append(mxp2)

    ts = interop.state_from_numpy(
        jax.tree.map(lambda x: np.asarray(x)[None], js), "cpu")
    NF = tc.dims.nf_rows
    for xp in frames:
        nxt, u = tracker_draws(js.key[None], NF)
        js = jax_tracker_pc(jc, js, jnp.asarray(mid), jnp.asarray(xp),
                            jnp.asarray(mdep), jnp.asarray(mval))
        np.testing.assert_array_equal(np.asarray(js.key), np.asarray(nxt[0]))
        ts = tracker_pointcloud(
            tc, ts, torch.tensor(mid[None], dtype=torch.int64),
            torch.tensor(xp[None]), torch.tensor(mdep[None]),
            torch.tensor(mval[None]), torch.tensor(u))
        assert int(ts.n_tracker_rejected[0]) == int(js.n_tracker_rejected)
    jfr, tfr = js.features, interop.state_to_numpy(ts).features
    for name in ("fid", "track", "status"):
        np.testing.assert_array_equal(getattr(tfr, name)[0],
                                      np.asarray(getattr(jfr, name)),
                                      err_msg=name)
    np.testing.assert_allclose(tfr.xp[0], np.asarray(jfr.xp), rtol=0,
                               atol=1e-12)
    # the reference test's claims, on the port's tables
    track, fid = tfr.track[0], tfr.fid[0]
    bad_rows = np.isin(fid, bad)
    good_rows = np.isin(fid, np.setdiff1d(ids, bad))
    assert int(ts.n_tracker_rejected[0]) >= 5
    assert (track[bad_rows] == TS_TRACKED).sum() == 0
    assert (track[bad_rows] == TS_DROPPED).sum() >= 5
    assert (track[good_rows] == TS_TRACKED).mean() > 0.9


def test_outlier_rejection_needs_its_draws():
    _, tc = _pc_cfgs()
    tc = dataclasses.replace(tc, dims=type(tc.dims)(4, 8, 16, 32))
    from xivo_tpu_torch.runner import batch_states
    s = batch_states(tc, 1, device="cpu")
    M = 4
    with pytest.raises(ValueError, match="hom_uniforms"):
        tracker_pointcloud(tc, s, torch.zeros((1, M), dtype=torch.int64),
                           torch.zeros((1, M, 2), dtype=torch.float64),
                           torch.zeros((1, M), dtype=torch.float64),
                           torch.ones((1, M), dtype=torch.bool))
