"""The recommended accuracy config through ``vio_frame`` against the JAX
package, on the CPU.

The config is ``bench.py::stage_consistency``'s: OOS (out-of-state,
MSCKF-style) updates, pose cloning and pose-only first-estimate Jacobians
(FEJ), built by ``xivo_tpu_torch.sim.configs.accuracy_config``. It and
two variants (``oos_fej``, ``fej_feature_block``) run 20 frames of two
sequences in float64 from the same initial state, carried across with
``interop``: poses within 1e-8 and every leaf of the final state within
1e-8 (the same float64 algebra in another operation order; ~1e-14 is
seen), the integer counts of ``StepOutputs`` exactly. The third variant,
the correlated-init pass (``approximate_init_covariance``), runs in
``test_torch_init_cov.py``, which also needs its reference state. The
port alone also runs the reference's ATE pin of the config on the bench
world at full width (``test_recommended_config_tracks_base_ate``).

OOS must fire for the comparison to mean anything. The PCW bench world
keeps its tracks for far longer than 20 frames, so no feature dies with
``OOS_min_observations`` (5) instate observations. The runs here use a
churn world instead (``tests/test_oos.py``'s: a 200 x 200 camera, the
``calib_rich`` motion over 900 points) with 6 group slots, where tracks
leave the view quickly; the tests assert that OOS rows were applied on
several frames of both sequences.

``accuracy_cfgs``, ``run_both``, ``check_outputs`` and
``check_final_state`` are shared with ``test_torch_oos.py`` and
``test_torch_init_cov.py``.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_pipeline import _walk, plain
from xivo_tpu.filter.config import config_from_json as jax_config_from_json
from xivo_tpu.filter.layout import Dims as JaxDims
from xivo_tpu.runner import batch_states as jax_batch_states
from xivo_tpu.runner import make_batch_runner as jax_batch_runner
from xivo_tpu.sim.stream import build_pcw_stream as jax_stream
from xivo_tpu_torch import interop
from xivo_tpu_torch.filter import oos as toos
from xivo_tpu_torch.filter.layout import Dims
from xivo_tpu_torch.runner import batch_states, make_batch_runner
from xivo_tpu_torch.sim.configs import ACCURACY, PCW_CFG, accuracy_config
from xivo_tpu_torch.sim.stream import build_pcw_stream

torch.set_num_threads(2)
DIMS = (6, 8, 16, 32)       # n_groups, n_features, ng_rows, nf_rows
FRAMES = 20
SEEDS = (1, 2)
TOL = 1e-8
MIN_OOS_FRAMES = 4          # frames with OOS rows applied, each sequence
VARIANTS = {"recommended": {}, "oos_fej": {"oos_fej": True},
            "fej_feature_block": {"fej_feature_block": True}}


def churn_world():
    """The PCW config on a 200 x 200 camera with a 24-track budget."""
    base = dict(PCW_CFG)
    base["camera_cfg"] = {"model": "pinhole", "rows": 200, "cols": 200,
                          "fx": 275, "fy": 275, "cx": 100, "cy": 100}
    base["tracker_cfg"] = dict(PCW_CFG["tracker_cfg"], num_features_max=24)
    return base


def accuracy_cfgs(dims=DIMS, **over):
    """(reference config, port config): the recommended accuracy config on
    the churn world, float64, with `over` on top."""
    world = churn_world()
    tc = accuracy_config(world, dtype="float64", dims=Dims(*dims), **over)
    jc = jax_config_from_json(
        world, dtype="float64", dims=JaxDims(*dims),
        sim_initialize_depths=True, propagation_mode="fast",
        covariance_form="sqrt", **dict(ACCURACY, **over))
    assert plain(jc) == plain(tc)
    return jc, tc


CHURN_STREAM = dict(noise_px=0.5, motion="calib_rich", n_points=900)


def churn_streams(jc, tc, frames=FRAMES, seeds=SEEDS):
    kw = dict(total_time=frames * 0.05, **CHURN_STREAM)
    return ([jax_stream(jc, seed=sd, **kw) for sd in seeds],
            [build_pcw_stream(tc, seed=sd, **kw) for sd in seeds])


@contextlib.contextmanager
def oos_rows_applied():
    """Record, per port frame, the OOS rows each sequence applied."""
    seen = []
    orig = toos.sqrt_update

    def rec(S, H, inn, diagR, row_valid):
        seen.append(row_valid.sum(-1).tolist())
        return orig(S, H, inn, diagR, row_valid)
    toos.sqrt_update = rec
    try:
        yield seen
    finally:
        toos.sqrt_update = orig


def run_both(jc, tc, frames=FRAMES, seeds=SEEDS):
    """Both packages' runs from one initial state: ((jax state, outs),
    (port state, outs), OOS rows per port frame (T, B))."""
    jstreams, tstreams = churn_streams(jc, tc, frames, seeds)
    js = jax_batch_states(jc, len(seeds))
    js = js._replace(
        last_gyro=jnp.asarray(np.stack([g["gyro0"] for _, g in jstreams])),
        last_accel=jnp.asarray(np.stack([g["accel0"] for _, g in jstreams])))
    ts = interop.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    jfi = jax.tree.map(lambda *x: jnp.stack(x), *[f for f, _ in jstreams])
    tfi = type(tstreams[0][0])(*(np.stack(x) for x in
                                 zip(*[f for f, _ in tstreams])))
    with oos_rows_applied() as rows:
        tout = make_batch_runner(tc)(ts, tfi)
    jout = jax_batch_runner(jc)(js, jfi)
    return (jax.tree.map(np.asarray, jout), tout, np.asarray(rows))


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def runs(request):
    jc, tc = accuracy_cfgs(**VARIANTS[request.param])
    return request.param, run_both(jc, tc)


def check_outputs(name, jo, to, rows):
    """StepOutputs of the port's run against the reference's: floats
    within TOL, counts exactly; OOS fired on several frames of each
    sequence and the window filled with clones."""
    for field in jo._fields:
        a, b = np.asarray(getattr(jo, field)), getattr(to, field).numpy()
        assert a.shape == b.shape == (len(SEEDS), FRAMES) + a.shape[2:]
        if np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(b, a, err_msg=f"{name} {field}")
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=TOL,
                                       err_msg=f"{name} {field}")
    assert ((rows > 0).sum(axis=0) >= MIN_OOS_FRAMES).all(), rows
    assert (np.asarray(jo.num_instate_groups)[:, -1] == DIMS[0]).all()
    assert int(np.asarray(jo.num_instate_features)[:, -1].min()) > 0


def check_final_state(name, js, ts):
    """Every leaf of the final state within TOL, with clones in the
    window."""
    for path, d in _walk(interop.state_to_numpy(ts), js):
        assert d <= TOL, (name, path, d)
    clones = ts.groups.is_clone & (ts.groups.sind >= 0)
    assert bool(clones.any()), name


def test_accuracy_config_matches_reference_frame_by_frame(runs):
    name, ((_, jo), (_, to), rows) = runs
    check_outputs(name, jo, to, rows)


def test_accuracy_config_final_state_matches_reference(runs):
    name, ((js, _), (ts, _), _) = runs
    check_final_state(name, js, ts)


def test_recommended_config_tracks_base_ate():
    """``tests/test_e2e_pcw.py::test_recommended_config_tracks_base_ate``
    on the port: the PCW bench world at full width (D = 228), float32, the
    5 s stream; the recommended config stays within the reference's bound
    of the base config's ATE-RMSE, and OOS fires."""
    ates, fired = {}, 0
    for name, cfg in (("base", accuracy_config(
            use_OOS=False, clone_frame_groups=False, use_fej=False)),
                      ("recommended", accuracy_config())):
        fi, gt = build_pcw_stream(cfg, total_time=5.0, noise_px=0.25)
        s = batch_states(cfg, 1, device="cpu")
        s = s._replace(last_gyro=torch.tensor(gt["gyro0"])[None].float(),
                       last_accel=torch.tensor(gt["accel0"])[None].float())
        with oos_rows_applied() as rows:
            _, out = make_batch_runner(cfg)(
                s, type(fi)(*(np.asarray(a)[None] for a in fi)))
        fired = max(fired, int(np.sum(np.asarray(rows) > 0)))
        err = np.linalg.norm(out.Tsb[0].numpy() - gt["Tsb"], axis=1)
        ates[name] = float(np.sqrt(np.mean(err ** 2)))
    print(f"ATE-RMSE {ates}")
    assert ates["recommended"] < max(1.25 * ates["base"], 0.015), ates
    assert fired >= 10
