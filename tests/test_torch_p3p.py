"""The port's P3P and P3P RANSAC (``xivo_tpu_torch/map/p3p.py``) against
the JAX package, on the CPU, in float64.

* ``p3p_grunert``: ``tests/test_mapper.py``'s case and 200 random
  triples. The port finds the quartic's roots in closed form where the
  reference takes companion-matrix eigenvalues, so the roots may come in
  another order: the valid hypotheses are compared as sets. Both solvers
  lose digits where two roots nearly coincide: over these triples the two
  differ by up to ~5e-8 where each is ~1e-7 from the true pose. So a
  hypothesis must match its counterpart within 1e-9, or be no farther
  from the true pose than twice the reference's.
* ``pnp_ransac`` with the reference's own draws (rebuilt from its key as
  ``jax.random`` makes them): ``tests/test_mapper.py``'s outlier case and
  random scenes with outliers and invalid rows. Inlier masks and ``ok``
  exactly, R and t of an accepted pose within 1e-9.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from xivo_tpu.map import p3p as jp
from xivo_tpu_torch.map import p3p as tp

torch.set_num_threads(2)
TOL = 1e-9


def triple(rng):
    R = Rotation.from_rotvec(rng.normal(0, 0.5, 3)).as_matrix()
    t = rng.normal(0, 1, 3)
    Xw = rng.uniform(-3, 3, (3, 3)) + np.array([0, 0, 8.0])
    Xc = Xw @ R.T + t
    return Xw, Xc / np.linalg.norm(Xc, axis=1, keepdims=True), R, t


def test_mapper_case_recovers_pose():
    rng = np.random.default_rng(5)
    R_true = Rotation.from_rotvec([0.3, -0.2, 0.5]).as_matrix()
    t_true = np.array([0.5, -1.0, 2.0])
    Xw = rng.uniform(-3, 3, (3, 3)) + np.array([0, 0, 8.0])
    Xc = Xw @ R_true.T + t_true
    f = Xc / np.linalg.norm(Xc, axis=1, keepdims=True)
    R4, t4, ok = tp.p3p_grunert(torch.tensor(Xw), torch.tensor(f))
    errs = [float(np.linalg.norm(R4[i].numpy() - R_true)
                  + np.linalg.norm(t4[i].numpy() - t_true))
            for i in range(4) if bool(ok[i])]
    assert min(errs) < 1e-6


def test_p3p_matches_reference_hypotheses():
    rng = np.random.default_rng(0)
    cases = [triple(rng) for _ in range(200)]
    Xw = np.stack([c[0] for c in cases])
    f = np.stack([c[1] for c in cases])
    jR, jt, jok = map(np.asarray, jax.vmap(jp.p3p_grunert)(
        jnp.asarray(Xw), jnp.asarray(f)))
    tR, tt, tok = (x.numpy() for x in tp.p3p_grunert(torch.tensor(Xw),
                                                     torch.tensor(f)))
    n_tight = 0
    for k, (_, _, R, t) in enumerate(cases):
        assert jok[k].sum() == tok[k].sum(), k
        truth = np.r_[R.ravel(), t]
        for i in np.nonzero(jok[k])[0]:
            a = np.r_[jR[k, i].ravel(), jt[k, i]]
            b = [np.r_[tR[k, j].ravel(), tt[k, j]]
                 for j in np.nonzero(tok[k])[0]]
            j = int(np.argmin([np.abs(a - x).max() for x in b]))
            d = np.abs(a - b[j]).max()
            if d < TOL:
                n_tight += 1
                continue
            # an ill-conditioned root: no worse than the reference's
            assert np.abs(b[j] - truth).max() <= max(
                2 * np.abs(a - truth).max(), TOL), (k, i, d)
    assert n_tight >= 0.9 * jok.sum()


def reference_draws(key, n_hyps, N):
    keys = jax.random.split(key, n_hyps)
    return np.asarray(jax.vmap(
        lambda k: jax.random.uniform(k, (N,), jnp.float64))(keys))


def scene(seed, N=40, n_out=8, n_invalid=0):
    rng = np.random.default_rng(seed)
    R = Rotation.from_rotvec(rng.normal(0, 0.3, 3)).as_matrix()
    t = rng.normal(0, 1, 3)
    Xw = rng.uniform(-4, 4, (N, 3)) + np.array([0, 0, 10.0])
    Xc = Xw @ R.T + t
    f = Xc / np.linalg.norm(Xc, axis=1, keepdims=True)
    f[:n_out] = rng.standard_normal((n_out, 3))
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    valid = np.ones(N, bool)
    valid[N - n_invalid:] = False
    return Xw, f, valid, R


SCENES = {"mapper_case": None, "outliers": dict(seed=11, n_out=12),
          "invalid_rows": dict(seed=12, N=30, n_out=5, n_invalid=9),
          "few_valid": dict(seed=13, N=30, n_out=0, n_invalid=27)}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_pnp_ransac_matches_reference_given_its_draws(name):
    if SCENES[name] is None:       # tests/test_mapper.py's case
        rng = np.random.default_rng(6)
        R_true = Rotation.from_rotvec([-0.1, 0.4, 0.2]).as_matrix()
        t_true = np.array([1.0, 0.3, -0.5])
        N = 40
        Xw = rng.uniform(-4, 4, (N, 3)) + np.array([0, 0, 10.0])
        Xc = Xw @ R_true.T + t_true
        f = Xc / np.linalg.norm(Xc, axis=1, keepdims=True)
        f[:8] = rng.standard_normal((8, 3))
        f /= np.linalg.norm(f, axis=1, keepdims=True)
        valid = np.ones(N, bool)
    else:
        Xw, f, valid, R_true = scene(**SCENES[name])
    key = jax.random.PRNGKey(1)
    jR, jt, jinl, jok = map(np.asarray, jp.pnp_ransac(
        key, jnp.asarray(Xw), jnp.asarray(f), jnp.asarray(valid)))
    u = reference_draws(key, tp.N_HYPS, Xw.shape[0])
    R, t, inl, ok = tp.pnp_ransac(torch.tensor(u)[None],
                                  torch.tensor(Xw)[None],
                                  torch.tensor(f)[None],
                                  torch.tensor(valid)[None])
    np.testing.assert_array_equal(inl[0].numpy(), jinl)
    assert bool(ok[0]) == bool(jok)
    if name != "few_valid":
        assert bool(jok) and np.linalg.norm(jR - R_true) < 1e-6
        np.testing.assert_allclose(R[0].numpy(), jR, rtol=0, atol=TOL)
        np.testing.assert_allclose(t[0].numpy(), jt, rtol=0, atol=TOL)
    else:
        # three valid points fit any of their poses: too few inliers. The
        # pose is then the first root of the best draw, whose order is the
        # solver's; the mapper uses only mask and ok
        assert not bool(jok) and int(inl.sum()) == 3
