"""The port's bundle adjustment and map with observations
(``xivo_tpu_torch/ba/core.py``, ``map/bigmap.py``) against the JAX
package, on the CPU, in float64.

* ``solve`` on ``tests/test_ba.py``'s problems (noise-free, noisy, gross
  outliers under Huber, a large perturbation at tiny damping): chi2
  histories within a relative 1e-8, poses and landmarks within 1e-8;
* ``refine_map`` on ``tests/test_bigmap.py``'s synthetic map: chi2 history
  and the refined tables likewise;
* ``retire_features_obs`` from a live filter state (20 frames of the PCW
  path, tiny Dims) into an empty map and again into the filled one:
  keyframe ring, observation rows and landmarks, integers exactly;
* ``mesh=`` (the landmark-sharded solver of ``dist/ba.py``) on a
  one-rank group equals the call without it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pipeline import jax_cfg, torch_cfg
from tests.test_ba import make_problem
from tests.test_bigmap import synthetic_bigmap
from xivo_tpu.ba import solve as jax_solve
from xivo_tpu.map.bigmap import init_bigmap as jax_init_bigmap
from xivo_tpu.map.bigmap import refine_map as jax_refine_map
from xivo_tpu.map.bigmap import retire_features_obs as jax_retire_obs
from xivo_tpu_torch import interop
from xivo_tpu_torch.ba.core import BAProblem, solve
from xivo_tpu_torch.map import bigmap as tb

torch.set_num_threads(2)
TOL = 1e-8


def lead(tree):
    return jax.tree.map(lambda x: np.asarray(x)[None], tree)


def to_port(p):
    return BAProblem(*(torch.from_numpy(np.array(x)) for x in lead(p)))


def close(a, b, name):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=TOL,
                               atol=TOL, err_msg=name)


PROBLEMS = {
    "noise_free": (dict(), dict(iters=15, damping=1e-6)),
    "noisy": (dict(noise_px=0.002, perturb=0.08, seed=3),
              dict(iters=15, damping=1e-5)),
    "outliers_huber": (dict(noise_px=0.001, perturb=0.05, seed=4),
                       dict(iters=15, damping=1e-5, huber_thresh=0.01)),
    "large_perturbation": (dict(perturb=0.4, seed=3),
                           dict(iters=12, damping=1e-9)),
}


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_solve_matches_reference(name):
    kw, skw = PROBLEMS[name]
    p, _ = make_problem(**kw)
    if name == "outliers_huber":     # tests/test_ba.py's corrupted rows
        obs, mask = np.array(p.obs), np.asarray(p.mask)
        rng = np.random.default_rng(9)
        for l in range(8):
            ks = np.nonzero(mask[l])[0]
            if len(ks):
                obs[l, ks[0]] += rng.standard_normal(2) * 0.5
        p = p._replace(obs=jnp.asarray(obs))
    jp, jh = jax_solve(p, **skw)
    tp, th = solve(to_port(p), **skw)
    close(th[0].numpy(), jh, "chi2")
    for f in ("Rs", "Ts", "Xs"):
        close(getattr(tp, f)[0].numpy(), getattr(jp, f), f)
    h = th[0].numpy()
    assert h[-1] < h[0] and np.all(np.diff(h) <= 1e-9 * np.maximum(h[:-1],
                                                                     1.0))


@pytest.fixture(scope="module")
def bigmap():
    from tests.test_bigmap import PCW_CFG
    from xivo_tpu.filter.config import config_from_json
    cfg = config_from_json(PCW_CFG, dtype="float64",
                           sim_initialize_depths=True)
    bm, Xs_true, kf_T = synthetic_bigmap(cfg)
    return cfg, bm, Xs_true, kf_T


def test_refine_map_matches_reference(bigmap):
    cfg, bm, Xs_true, kf_T = bigmap
    jbm, jchi = jax_refine_map(cfg, bm, iters=12, damping=1e-6)
    tbm, tchi = tb.refine_map(None, interop.bigmap_from_numpy(lead(bm),
                                                              "cpu"),
                              iters=12, damping=1e-6)
    close(tchi[0].numpy(), jchi, "chi2")
    out = interop.bigmap_to_numpy(tbm)
    for f in ("Xs", "kf_R", "kf_T"):
        close(getattr(out, f)[0], getattr(jbm, f), f)
    err1 = np.linalg.norm(out.Xs[0, :64] - Xs_true, axis=1).mean()
    err0 = np.linalg.norm(np.asarray(bm.Xs[:64]) - Xs_true, axis=1).mean()
    assert err1 < 0.2 * err0


@pytest.fixture
def one_rank_gloo():
    """A one-rank gloo group of this process, taken down after the test so
    that no later test on this worker inherits it."""
    import torch.distributed as dist
    from xivo_tpu_torch.dist.multihost import global_mesh
    yield global_mesh("gloo")
    dist.destroy_process_group()


def test_refine_map_mesh_names_the_roadmap_item(bigmap, one_rank_gloo):
    """``mesh=`` (ROADMAP A.18): the landmark-sharded solver on a one-rank
    gloo group of this process gives ``refine_map()``'s result exactly
    (``test_torch_dist.py`` holds it at two ranks)."""
    cfg, bm, _, _ = bigmap
    tbm = interop.bigmap_from_numpy(lead(bm), "cpu")
    want, wchi = tb.refine_map(None, tbm, iters=12, damping=1e-6)
    got, chi = tb.refine_map(None, tbm, iters=12, damping=1e-6,
                             mesh=one_rank_gloo)
    assert torch.equal(chi, wchi)
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_retire_features_obs_matches_reference():
    from test_torch_pipeline import _streams
    from xivo_tpu.runner import batch_states as jax_batch_states
    from xivo_tpu.runner import make_batch_runner as jax_batch_runner
    jc, tc = jax_cfg(), torch_cfg()
    [(fi, gt)], _ = _streams(jc, tc, 20, (1,))
    js = jax_batch_states(jc, 1)._replace(
        last_gyro=jnp.asarray(gt["gyro0"])[None],
        last_accel=jnp.asarray(gt["accel0"])[None])
    js, _ = jax_batch_runner(jc)(js, jax.tree.map(lambda x: x[None], fi))
    s = jax.tree.map(lambda x: x[0], js)
    ts = interop.state_from_numpy(lead(s), "cpu")
    jbm = jax_init_bigmap(jc, capacity=64, obs_cap=4, kf_capacity=8,
                          dtype=jnp.float64)
    tbm = interop.bigmap_from_numpy(lead(jbm), "cpu")
    fr = s.features
    masks = [np.asarray(fr.sind) >= 0, np.asarray(fr.fid) >= 0]
    assert masks[0].any()
    for mask in masks:
        jbm = jax_retire_obs(jc, s, jbm, jnp.asarray(mask))
        tbm = tb.retire_features_obs(tc, ts, tbm,
                                     torch.from_numpy(mask)[None])
        a, b = lead(jbm), interop.bigmap_to_numpy(tbm)
        for name in a._fields:
            x, y = np.asarray(getattr(a, name)), getattr(b, name)
            assert x.shape == y.shape, name
            if x.dtype.kind in "iub":
                np.testing.assert_array_equal(y, x, err_msg=name)
            else:
                np.testing.assert_allclose(y, x, rtol=0, atol=1e-12,
                                           err_msg=name)
    assert int(jbm.count) > 0 and int((np.asarray(jbm.obs_kf) >= 0).sum())
