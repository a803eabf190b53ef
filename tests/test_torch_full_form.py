"""The reference's default filter (dense covariance, Joseph updates) through
the port's ``vio_frame`` against the JAX package, float64 on the CPU.

Each case runs two sequences from one initial state, carried across with
``interop``, at the tiny Dims of ``__graft_entry__._tiny_cfg`` (the churn
world's for the accuracy config): 10 frames of the PCW world (features
enter the state at frame 3) and 20 of the churn world (OOS first fires at
frame 10). The cases, one a file to keep each file short:

* ``pcw_default`` (here): ``config_from_json(PCW_CFG)`` with no filter
  override, so the reference's defaults: ``propagation_mode="reference"``
  (joint X/F/P Prince-Dormand substeps per IMU sample) and
  ``covariance_form="full"``;
* ``pcw_fast_full`` and ``pcw_fast_loop`` (``test_torch_full_form_fast.py``):
  fast propagation in the full form (the dense-P branch of the frame
  propagation), and the ``fast_substeps=0`` loop in the square-root form
  (ROADMAP C.1);
* ``accuracy_full_compressed`` (``test_torch_full_form_accuracy.py``): the
  recommended accuracy config (OOS updates, pose cloning, pose-only FEJ)
  in the full form on the churn world of ``test_torch_accuracy_pipeline.py``,
  with OOS measurement compression forced (``compression_trigger_ratio=
  0.5``, so B1 factors the bordered Gram every frame) and a dense Joseph
  update of the compressed rows.

Poses within 1e-8 m, every leaf of the final state within 1e-8 (P within
1e-8 of its largest entry), the integer counts of ``StepOutputs`` exactly,
and P's exactly-zero rows and columns (empty slots, gauge-fixed entries)
the same. The dense branches of ``joseph_update``, ``mh_distances`` and
``zero_state_entries`` (here) and the mapper's ``close_loop`` gate and
``retire_features`` blocks (the accuracy file) are held against the
reference on a seeded dense P, the dense correlated-init pass on the
accuracy run's P (the accuracy file too). ``run_case``, ``check_frames`` and
``check_final_state`` are shared with those files.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xivo_tpu.filter.config import config_from_json as jax_config_from_json
from xivo_tpu.filter.layout import Dims as JaxDims
from xivo_tpu.runner import batch_states as jax_batch_states
from xivo_tpu.runner import make_batch_runner as jax_batch_runner
from xivo_tpu.sim.configs import PCW_CFG as JAX_PCW_CFG
from xivo_tpu_torch import interop
from xivo_tpu_torch.filter import oos as toos
from xivo_tpu_torch.filter.config import config_from_json
from xivo_tpu_torch.filter.layout import Dims
from xivo_tpu_torch.runner import make_batch_runner
from xivo_tpu_torch.sim.configs import ACCURACY, PCW_CFG

from test_torch_accuracy_pipeline import DIMS as CHURN_DIMS
from test_torch_accuracy_pipeline import churn_world
from test_torch_pipeline import TINY, _streams, _walk, plain

torch.set_num_threads(2)
FRAMES = {"pcw": 10, "churn": 20}     # frames a run, by world
SEEDS = (1, 2)
TOL = 1e-8
COMPRESS = 0.5


CASES = {
    "pcw_default": {},
    "pcw_fast_full": dict(propagation_mode="fast"),
    "pcw_fast_loop": dict(propagation_mode="fast", covariance_form="sqrt",
                          fast_substeps=0),
    "accuracy_full_compressed": dict(
        ACCURACY, sim_initialize_depths=True, propagation_mode="fast",
        compression_trigger_ratio=COMPRESS),
}


def case_cfgs(case):
    """(reference config, port config, world name) of a case, float64."""
    over = CASES[case]
    if case.startswith("accuracy"):
        world, jworld, dims = churn_world(), churn_world(), CHURN_DIMS
    else:
        world, jworld, dims = PCW_CFG, JAX_PCW_CFG, TINY
    jc = jax_config_from_json(jworld, dims=JaxDims(*dims), dtype="float64",
                              **over)
    tc = config_from_json(world, dims=Dims(*dims), dtype="float64", **over)
    assert plain(jc) == plain(tc)
    assert tc.covariance_form == over.get("covariance_form", "full")
    assert tc.propagation_mode == over.get("propagation_mode", "reference")
    return jc, tc, world_of(case)


def world_of(case):
    return "churn" if case.startswith("accuracy") else "pcw"


@contextlib.contextmanager
def joseph_rows_applied():
    """Record, per port frame, the OOS rows each sequence applied."""
    seen = []
    orig = toos.joseph_rows

    def rec(P, H, inn, diagR, row_valid):
        seen.append(row_valid.sum(-1).tolist())
        return orig(P, H, inn, diagR, row_valid)
    toos.joseph_rows = rec
    try:
        yield seen
    finally:
        toos.joseph_rows = orig


def streams(jc, tc, world):
    if world == "pcw":
        return _streams(jc, tc, FRAMES[world], SEEDS)
    from test_torch_accuracy_pipeline import churn_streams
    return churn_streams(jc, tc, FRAMES[world], SEEDS)


def run_case(case):
    """Both packages' runs of a case: (case, port config, reference
    (state, outs) as numpy, port (state, outs), OOS rows of the dense
    updates per port frame (T, B))."""
    jc, tc, world = case_cfgs(case)
    jstreams, tstreams = streams(jc, tc, world)
    js = jax_batch_states(jc, len(SEEDS))
    js = js._replace(
        last_gyro=jnp.asarray(np.stack([g["gyro0"] for _, g in jstreams])),
        last_accel=jnp.asarray(np.stack([g["accel0"] for _, g in jstreams])))
    ts = interop.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    D = tc.dims.full
    assert ts.P.shape[:2] == (len(SEEDS), D)
    jfi = jax.tree.map(lambda *x: jnp.stack(x), *[f for f, _ in jstreams])
    tfi = type(tstreams[0][0])(*(np.stack(x) for x in
                                 zip(*[f for f, _ in tstreams])))
    with joseph_rows_applied() as rows:
        tout = make_batch_runner(tc)(ts, tfi)
    jout = jax.tree.map(np.asarray, jax_batch_runner(jc)(js, jfi))
    return case, tc, jout, tout, np.asarray(rows)


def check_frames(run):
    """StepOutputs frame by frame: floats within TOL, counts exactly."""
    name, tc, (_, jo), (_, to), rows = run
    T = FRAMES[world_of(name)]
    for field in jo._fields:
        a, b = np.asarray(getattr(jo, field)), getattr(to, field).numpy()
        assert a.shape == b.shape == (len(SEEDS), T) + a.shape[2:]
        if np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(b, a, err_msg=f"{name} {field}")
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=TOL,
                                       err_msg=f"{name} {field}")
    # the run did real work: features and groups entered the state
    assert int(np.asarray(jo.num_instate_features)[:, -1].min()) > 0
    assert int(np.asarray(jo.num_instate_groups)[:, -1].min()) > 0
    if tc.use_OOS:
        # compression ran on every frame, and OOS rows reached the update
        assert rows.shape == (T, len(SEEDS))
        assert ((rows > 0).sum(axis=0) >= 4).all(), rows


def check_final_state(run):
    """Every leaf of the final state within TOL (P relative to its largest
    entry), and P's exactly-zero rows and columns the same."""
    name, tc, (js, _), (ts, _), _ = run
    P, Pj = ts.P.numpy(), np.asarray(js.P)
    scale = np.abs(Pj).max()
    assert np.abs(P - Pj).max() <= TOL * scale, name
    for axis in (1, 2):
        zero, zero_j = (P == 0).all(axis=axis), (Pj == 0).all(axis=axis)
        np.testing.assert_array_equal(zero, zero_j, err_msg=name)
        assert zero.any(), name
    for path, d in _walk(interop.state_to_numpy(ts), js):
        if path != ".P":
            assert d <= TOL, (name, path, d)


@pytest.fixture(scope="module")
def run():
    return run_case("pcw_default")


def test_default_filter_frames_match_reference(run):
    check_frames(run)


def test_default_filter_final_state_matches_reference(run):
    check_final_state(run)


# ---------------------------------------------------------------------------
# the dense branches on a seeded dense P
# ---------------------------------------------------------------------------

RNG = np.random.default_rng(23)


def dense_P(n, D, dead):
    """n SPD matrices with the rows and columns in `dead` exactly zero."""
    A = RNG.standard_normal((n, D, D)) * 0.1
    P = A @ A.transpose(0, 2, 1) + 1e-2 * np.eye(D)
    keep = np.ones(D)
    keep[list(dead)] = 0.0
    return P * keep[:, None] * keep[None, :]


def _pair():
    from test_torch_pipeline import jax_cfg, torch_cfg
    return (dataclasses.replace(jax_cfg(), covariance_form="full",
                                propagation_mode="reference"),
            dataclasses.replace(torch_cfg(), covariance_form="full",
                                propagation_mode="reference"))


def test_dense_update_blocks_match_reference():
    """joseph_update, mh_distances and zero_state_entries on seeded dense
    P with dead rows and columns: values within 1e-10 relative, the dead
    rows and columns exactly zero after the update."""
    from xivo_tpu.filter import update as ju
    from xivo_tpu_torch.filter import update as tu
    jc, tc = _pair()
    D, F, n = tc.dims.full, tc.dims.n_features, 3
    dead = list(range(D - 6, D)) + [10, 11]
    P = dense_P(n, D, dead)
    H = RNG.standard_normal((n, 2 * F, D))
    H[..., dead[:6]] = 0.0
    inn = RNG.standard_normal((n, 2 * F))
    diagR = np.full((n, 2 * F), 1.5)
    valid = RNG.random((n, F)) > 0.3
    keep = RNG.random((n, D)) > 0.2

    err_j, P_j = jax.vmap(ju.joseph_update)(*(jnp.asarray(v) for v in
                                              (P, H, inn, diagR, valid)))
    err_t, P_t = tu.joseph_update(*(torch.tensor(v) for v in
                                    (P, H, inn, diagR, valid)))
    for a, b in ((err_t, err_j), (P_t, P_j)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-10 * np.abs(b).max()
    assert not P_t.numpy()[:, dead].any() and not P_t.numpy()[:, :, dead].any()

    dist_j = jax.vmap(lambda p, h, i: ju.mh_distances(p, h, i, jc.R))(
        *(jnp.asarray(v) for v in (P, H, inn)))
    dist_t = tu.mh_distances(*(torch.tensor(v) for v in (P, H, inn)), tc.R)
    np.testing.assert_allclose(dist_t.numpy(), np.asarray(dist_j),
                               rtol=1e-10, atol=0)

    z_j = jax.vmap(ju.zero_state_entries)(jnp.asarray(P), jnp.asarray(keep))
    z_t = tu.zero_state_entries(torch.tensor(P), torch.tensor(keep))
    np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j))
    # the measurement update dispatches on the form
    err_d, P_d = tu.measurement_update(*(torch.tensor(v) for v in
                                         (P, H, inn, diagR, valid)))
    assert torch.equal(P_d, P_t) and torch.equal(err_d, err_t)
