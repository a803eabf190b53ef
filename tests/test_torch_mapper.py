"""The port's sparse map and loop closure (``xivo_tpu_torch/map/mapper.py``)
against the JAX package, on the CPU, in float64.

* ``map_insert``: ``tests/test_mapper.py``'s ring buffer (with its
  wrap-around), fusion on re-retirement (and a new landmark after it),
  the fusion radius, and rows that do not retire beside near and exact
  copies of map entries (the port's search skips them through its query
  mask; the reference scores every row); the tables equal the
  reference's (integers exactly, positions and covariances within
  1e-12);
* ``close_loop`` on ``tests/test_mapper.py``'s drift scenario (a map at
  the true poses, a filter that believes it drifted), in the square-root
  form, with the reference's
  RANSAC draws rebuilt from its key: closure count exactly, the state
  within 1e-9, the drift corrected; again with the anchor-pose rows on;
* ``retire_features`` from the drift scenario's state into an empty and a
  filled map, fusion on;
* ``matcher=`` (the sharded search of ``dist/retrieval.py``) on a
  one-rank group equals the search without it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_mapped_pipeline import reference_draws
from test_torch_pipeline import _walk
from xivo_tpu.map import init_map as jax_init_map
from xivo_tpu.map import map_insert as jax_map_insert
from xivo_tpu.map.mapper import close_loop as jax_close_loop
from xivo_tpu.map.mapper import retire_features as jax_retire_features
from xivo_tpu_torch import interop
from xivo_tpu_torch.filter.config import config_from_json
from xivo_tpu_torch.map import mapper as tm
from xivo_tpu_torch.runner import batch_maps
from xivo_tpu_torch.sim.configs import PCW_CFG

torch.set_num_threads(2)


def lead(tree):
    """A reference tree (numpy leaves) with a batch axis of 1."""
    return jax.tree.map(lambda x: np.asarray(x)[None], tree)


def port_map(jms):
    return interop.map_from_numpy(lead(jms), "cpu")


def same_map(jms, tms, tol=1e-12):
    a, b = lead(jms), interop.map_to_numpy(tms)
    for name in a._fields:
        x, y = np.asarray(getattr(a, name)), getattr(b, name)
        assert x.shape == y.shape, name
        if x.dtype.kind in "iub":
            np.testing.assert_array_equal(y, x, err_msg=name)
        else:
            np.testing.assert_allclose(y, x, rtol=0, atol=tol, err_msg=name)


def t64(a, dtype=None):
    return torch.from_numpy(np.asarray(a).astype(dtype or np.asarray(a).dtype)
                            )[None]


def insert_both(jms, Xs, desc, valid, cov=None, **kw):
    j = jax_map_insert(jms, jnp.asarray(Xs), jnp.asarray(desc),
                       jnp.asarray(valid),
                       cov=None if cov is None else jnp.asarray(cov), **kw)
    t = tm.map_insert(port_map(jms), t64(Xs), t64(desc, np.int64),
                      t64(valid), cov=None if cov is None else t64(cov), **kw)
    same_map(j, t)
    return j


def test_map_ring_buffer_matches_reference():
    rng = np.random.default_rng(7)
    ms = jax_init_map(capacity=16, dtype=jnp.float64)
    Xs = rng.standard_normal((10, 3))
    desc = rng.integers(0, 2 ** 32, (10, 8), dtype=np.uint32)
    ms = insert_both(ms, Xs, desc, np.ones(10, bool))
    valid = np.ones(10, bool)
    valid[3] = False
    ms = insert_both(ms, Xs, desc, valid)        # wraps around
    assert int(ms.count) == 19 and int(ms.write_ptr) == 3


def test_map_fusion_matches_reference():
    rng = np.random.default_rng(3)
    ms = jax_init_map(capacity=64, dtype=jnp.float64)
    Xs = rng.uniform(-2, 2, (6, 3))
    desc = rng.integers(0, 2 ** 32, (6, 8), dtype=np.uint32)
    cov = np.tile(0.2 * np.eye(3), (6, 1, 1))
    ms = insert_both(ms, Xs, desc, np.ones(6, bool), cov=cov,
                     nn_dist_thresh=30)
    # re-retire, moved; two retirees on one target: one fuses
    Xs2 = Xs + rng.normal(0, 0.05, (6, 3))
    desc2 = desc.copy()
    desc2[5] = desc[4]
    desc2[5, 0] ^= np.uint32(3)
    Xs2[5] = Xs2[4] + 0.01
    cov2 = cov * rng.uniform(0.5, 2.0, (6, 1, 1))
    ms2 = insert_both(ms, Xs2, desc2, np.ones(6, bool), cov=cov2,
                      nn_dist_thresh=30)
    assert int(ms2.n_merged) == 5 and int(ms2.count) == 7
    # a new descriptor ring-inserts
    nd = rng.integers(0, 2 ** 32, (1, 8), dtype=np.uint32)
    ms3 = insert_both(ms2, Xs[:1] + 5.0, nd, np.ones(1, bool), cov=cov[:1],
                      nn_dist_thresh=30)
    assert int(ms3.count) == 8


def test_map_fusion_radius_matches_reference():
    rng = np.random.default_rng(4)
    ms = jax_init_map(capacity=32, dtype=jnp.float64)
    Xs = np.array([[0.0, 0.0, 1.0]])
    desc = rng.integers(0, 2 ** 32, (1, 8), dtype=np.uint32)
    cov = 0.1 * np.eye(3)[None]
    ms = insert_both(ms, Xs, desc, np.ones(1, bool), cov=cov,
                     nn_dist_thresh=30)
    ms2 = insert_both(ms, Xs + 10.0, desc, np.ones(1, bool), cov=cov,
                      nn_dist_thresh=30, merge_radius=0.5)
    assert int(ms2.count) == 2 and int(ms2.n_merged) == 0


def test_map_fusion_ignores_rows_that_do_not_retire():
    """Rows 3 and 4 of the second batch are copies of map entries within
    the merge radius (row 3 two bits away, row 4 exact) but do not retire:
    they must neither fuse nor insert, while rows 0-2 fuse."""
    rng = np.random.default_rng(11)
    ms = jax_init_map(capacity=64, dtype=jnp.float64)
    Xs = rng.uniform(-2, 2, (6, 3))
    desc = rng.integers(0, 2 ** 32, (6, 8), dtype=np.uint32)
    cov = np.tile(0.2 * np.eye(3), (6, 1, 1))
    ms = insert_both(ms, Xs, desc, np.ones(6, bool), cov=cov,
                     nn_dist_thresh=30)
    Xs2 = Xs + rng.normal(0, 0.05, (6, 3))
    desc2 = desc.copy()
    desc2[3, 0] ^= np.uint32(3)
    retiring = np.array([1, 1, 1, 0, 0, 0], bool)
    ms2 = insert_both(ms, Xs2, desc2, retiring, cov=cov, nn_dist_thresh=30)
    assert int(ms2.n_merged) == 3 and int(ms2.count) == 6


@pytest.fixture(scope="module")
def drift():
    """``tests/test_mapper.py``'s drift scenario in the square-root form
    the port runs: the same tables and pose, the pose block's standard
    deviation 0.5 in the factor."""
    from tests.test_mapper import _drift_scenario
    from xivo_tpu.filter import layout as L
    from xivo_tpu.filter.config import config_from_json as jax_cfg
    from xivo_tpu.filter.state import init_state
    from xivo_tpu.sim.configs import PCW_CFG as JAX_PCW_CFG
    _, s_full, ms, drift = _drift_scenario()
    slice_ = dict(dtype="float64", propagation_mode="fast",
                  covariance_form="sqrt")
    jc = jax_cfg(JAX_PCW_CFG, **slice_)
    tc = config_from_json(PCW_CFG, **slice_)
    s = init_state(jc)
    P = s.P.at[L.TSB:L.TSB + 3, L.TSB:L.TSB + 3].set(
        0.5 * jnp.eye(3, dtype=jnp.float64))
    s = s._replace(X=s_full.X, features=s_full.features,
                   f2row=s_full.f2row, P=P)
    ts = interop.state_from_numpy(lead(s), "cpu")
    return jc, tc, s, ms, ts, drift


@pytest.mark.parametrize("anchor_rows", [False, True])
def test_close_loop_matches_reference_on_drift(drift, anchor_rows):
    """With ``lc_anchor_rows`` the map entries carry the gid of a group
    still in the window (slot 0, pose uncertainty 0.1), so the anchor-pose
    block enters the rows."""
    import dataclasses
    from xivo_tpu.filter import layout as L
    jc, tc, s, ms, ts, d = drift
    if anchor_rows:
        jc = dataclasses.replace(jc, lc_anchor_rows=True)
        tc = dataclasses.replace(tc, lc_anchor_rows=True)
        gb = L.GROUP_BEGIN
        s = s._replace(
            groups=s.groups._replace(gid=s.groups.gid.at[0].set(5),
                                     sind=s.groups.sind.at[0].set(0)),
            g2row=s.g2row.at[0].set(0),
            P=s.P.at[gb:gb + 6, gb:gb + 6].set(0.1 * jnp.eye(6)))
        ms = ms._replace(gid=jnp.full_like(ms.gid, 5))
        ts = interop.state_from_numpy(lead(s), "cpu")
    js2, jn = jax_close_loop(jc, s, ms)
    _, u = reference_draws(s.key[None], tc.dims.n_features, jnp.float64)
    ts2, n = tm.close_loop(tc, ts, port_map(ms), torch.from_numpy(u))
    assert int(n[0]) == int(jn) >= 5
    for path, diff in _walk(interop.state_to_numpy(ts2), lead(js2)):
        assert diff <= 1e-9, (path, diff)
    assert np.linalg.norm(ts2.X.Tsb[0].numpy()) < 0.1 * np.linalg.norm(d)
    if anchor_rows:   # the anchor block took part
        plain_rows, _ = tm.close_loop(
            dataclasses.replace(tc, lc_anchor_rows=False), ts, port_map(ms),
            torch.from_numpy(u))
        assert float((plain_rows.P - ts2.P).abs().max()) > 1e-6


def test_retire_features_matches_reference(drift):
    jc, tc, s, ms, ts, _ = drift
    mask = np.zeros(jc.dims.nf_rows, bool)
    mask[:12] = True
    empty = jax_init_map(128, dtype=jnp.float64)
    for jm in (empty, ms):      # into an empty map, and fused into ms
        j = jax_retire_features(jc, s, jm, jnp.asarray(mask))
        t = tm.retire_features(tc, ts, port_map(jm), t64(mask))
        same_map(j, t, tol=1e-10)
        assert int(j.count) + int(j.n_merged) > int(jm.count) \
            + int(jm.n_merged)


@pytest.fixture
def one_rank_gloo():
    """A one-rank gloo group of this process, taken down after the test so
    that no later test on this worker inherits it."""
    import torch.distributed as dist
    from xivo_tpu_torch.dist.multihost import global_mesh
    yield global_mesh("gloo")
    dist.destroy_process_group()


def test_sharded_matcher_names_the_roadmap_item(drift, one_rank_gloo):
    """``matcher=`` (ROADMAP A.18): the sharded matcher on a one-rank gloo
    group of this process finds what the single search finds, on the drift
    scenario where the closure fires (``test_torch_dist.py`` holds it at
    two ranks)."""
    from xivo_tpu_torch.dist import make_sharded_matcher
    _, tc, s, ms, ts, _ = drift
    _, u = reference_draws(s.key[None], tc.dims.n_features, jnp.float64)
    u = torch.from_numpy(np.array(u))
    want = tm.detect_loop_closures(tc, ts, port_map(ms), u)
    got = tm.detect_loop_closures(
        tc, ts, port_map(ms), u,
        matcher=make_sharded_matcher(one_rank_gloo))
    assert bool(want[3][0]) and int(want[2].sum()) >= 5
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_batch_maps_on_cpu():
    ms = batch_maps(100, 3, device="cpu", dtype=torch.float64)
    assert ms.Xs.shape == (3, 100, 3) and ms.desc.dtype == torch.int64
    assert ms.valid.shape == (3, 100) and not bool(ms.valid.any())
    assert ms.count.shape == (3,) and bool((ms.gid == -1).all())
