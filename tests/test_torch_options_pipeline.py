"""The other filter options through ``vio_frame`` against the JAX package,
on the CPU in float64: Huber, 1-point RANSAC and the two OC-EKF switches
here, depth refinement, online camera calibration and all of them
together in ``test_torch_options_pipeline_calib.py``.

Each case runs 20 frames of two PCW sequences at the tiny Dims of
``test_torch_pipeline.py`` in the square-root form with fast propagation,
on ``sim.configs.PCW_CALIB_CFG`` (PCW_CFG with initial intrinsics stds),
from one initial state carried across with ``interop``. From frame 5 on,
``sim.stream.corrupt_measurements`` moves 10 % of the measurements by
8-20 px, so that the options have outliers to act on. Poses and every
leaf of the final state (the factor included) agree within 1e-8, the
counts of ``StepOutputs`` exactly. Each case also shows that its branch
changed the outcome, recorded on the port's run: Huber inflated some R
(scale > 1), 1-point RANSAC rejected features (in both packages), the OC
correction moved Phi, the OC projection moved H, the refinement moved
candidate depths, the calibration moved the intrinsics.

``run_case`` is shared with the calib file.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_pipeline import TINY, _walk, plain
from xivo_tpu.filter.config import config_from_json as jax_config_from_json
from xivo_tpu.filter.layout import Dims as JaxDims
from xivo_tpu.runner import batch_states as jax_batch_states
from xivo_tpu.runner import make_batch_runner as jax_batch_runner
from xivo_tpu_torch import interop
from xivo_tpu_torch.filter import pipeline, update
from xivo_tpu_torch.filter.config import config_from_json
from xivo_tpu_torch.filter.layout import Dims
from xivo_tpu_torch.runner import make_batch_runner
from xivo_tpu_torch.sim.configs import OPTIONS, PCW_CALIB_CFG
from xivo_tpu_torch.sim.stream import build_pcw_stream, corrupt_measurements

torch.set_num_threads(2)
FRAMES = 20
SEEDS = (1, 2)
TOL = 1e-8
BASE = dict(dtype="float64", sim_initialize_depths=True,
            propagation_mode="fast", covariance_form="sqrt")
CASES = {name: {name: True} for name in
         ("use_huber", "use_1pt_RANSAC", "use_oc", "use_oc_meas",
          "use_depth_opt", "online_camera_calib")}
CASES["all"] = OPTIONS


def cfgs(over):
    """(reference config, port config) of PCW_CALIB_CFG at the tiny Dims
    with `over` on top."""
    jc = jax_config_from_json(PCW_CALIB_CFG, dims=JaxDims(*TINY),
                              **BASE, **over)
    tc = config_from_json(PCW_CALIB_CFG, dims=Dims(*TINY), **BASE, **over)
    assert plain(jc) == plain(tc)
    return jc, tc


@contextlib.contextmanager
def branch_effects():
    """Record, on the port's run, how far each option's branch moved what
    it acts on: the largest Huber scale, |dPhi| of the OC correction, |dH|
    of the OC projection, |dx| of the depth refinement."""
    seen = {"huber": 1.0, "oc_phi": 0.0, "oc_rows": 0.0, "refine": 0.0}
    orig = (pipeline.huber_robustify_R, pipeline.oc_correct_phi,
            update.oc_project_rows, pipeline._refine_candidate_depths)

    def huber(inn, R, thresh, dtype):
        out = orig[0](inn, R, thresh, dtype)
        seen["huber"] = max(seen["huber"], float(out.max()) / R)
        return out

    def oc_phi(cfg, Phi, *args):
        out = orig[1](cfg, Phi, *args)
        seen["oc_phi"] = max(seen["oc_phi"], float((out - Phi).abs().max()))
        return out

    def oc_rows(H, N):
        out = orig[2](H, N)
        seen["oc_rows"] = max(seen["oc_rows"], float((out - H).abs().max()))
        return out

    def refine_depths(cfg, s):
        out = orig[3](cfg, s)
        moved = (out.features.x - s.features.x).abs() \
            * (out.features.fid >= 0)[..., None]
        seen["refine"] = max(seen["refine"], float(moved.max()))
        return out

    (pipeline.huber_robustify_R, pipeline.oc_correct_phi,
     update.oc_project_rows, pipeline._refine_candidate_depths) = (
        huber, oc_phi, oc_rows, refine_depths)
    try:
        yield seen
    finally:
        (pipeline.huber_robustify_R, pipeline.oc_correct_phi,
         update.oc_project_rows, pipeline._refine_candidate_depths) = orig


def corrupted_streams(tc, frames=FRAMES, seeds=SEEDS):
    """The seeds' PCW streams, 10 % of the measurements moved 8-20 px from
    frame 5 on, stacked (B, T, ...); and their ground truths."""
    streams = [build_pcw_stream(tc, seed=sd, total_time=frames * 0.05,
                                noise_px=0.25) for sd in seeds]
    fis = [corrupt_measurements(fi, 100 + sd, start=5)
           for (fi, _), sd in zip(streams, seeds)]
    return (type(fis[0])(*(np.stack(x) for x in zip(*fis))),
            [gt for _, gt in streams])


def run_case(over):
    """Both packages' runs of a case from one initial state: (jax state,
    jax outputs, port state, port outputs, branch effects, initial
    intrinsics), numpy on the JAX side."""
    jc, tc = cfgs(over)
    fi, gts = corrupted_streams(tc)
    js = jax_batch_states(jc, len(SEEDS))
    js = js._replace(
        last_gyro=jnp.asarray(np.stack([g["gyro0"] for g in gts])),
        last_accel=jnp.asarray(np.stack([g["accel0"] for g in gts])))
    js0 = jax.tree.map(np.asarray, js)      # the runner donates js
    ts = interop.state_from_numpy(js0, "cpu")
    with branch_effects() as seen:
        ts_end, tout = make_batch_runner(tc)(ts, fi)
    js_end, jout = jax_batch_runner(jc)(js, jax.tree.map(jnp.asarray, fi))
    return (jax.tree.map(np.asarray, js_end), jax.tree.map(np.asarray, jout),
            ts_end, tout, seen, js0.cam)


def check_case(name, res):
    """The comparison and the branch's evidence for case `name`."""
    js, jo, ts, to, seen, cam0 = res
    for field in jo._fields:
        a, b = np.asarray(getattr(jo, field)), getattr(to, field).numpy()
        assert a.shape == b.shape == (len(SEEDS), FRAMES) + a.shape[2:]
        if np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(b, a, err_msg=f"{name} {field}")
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=TOL,
                                       err_msg=f"{name} {field}")
    for path, d in _walk(interop.state_to_numpy(ts), js):
        assert d <= TOL, (name, path, d)
    assert int(jo.num_instate_features[:, -1].min()) > 0
    on = CASES[name]
    if on.get("use_huber"):
        assert seen["huber"] > 1.0, seen
    if on.get("use_1pt_RANSAC"):
        assert jo.num_oneptransac_rejected.sum(1).min() > 0
    if on.get("use_oc"):
        assert seen["oc_phi"] > 1e-9, seen
    if on.get("use_oc_meas"):
        assert seen["oc_rows"] > 1e-9, seen
    if on.get("use_depth_opt"):
        assert seen["refine"] > 1e-9, seen
    if on.get("online_camera_calib"):
        assert np.abs(js.cam - cam0).max() > 1e-6
    else:
        np.testing.assert_array_equal(js.cam, cam0)


@pytest.mark.parametrize("name", ["use_huber", "use_1pt_RANSAC", "use_oc",
                                  "use_oc_meas"])
def test_option_matches_reference_over_20_frames(name):
    check_case(name, run_case(CASES[name]))
