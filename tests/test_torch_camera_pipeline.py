"""The PCW path through the distorted camera models, the port against the
JAX package on the CPU in float64.

* ``build_pcw_stream(use_cfg_camera=True)`` projects the world through
  the config's own lens (tests/test_camera_models_e2e.py's equidistant
  and radtan cameras): the same ids, pixels within 1e-12 (the two
  packages evaluate the lens in another order), the rest bit-equal;
* ``vio_frame``: 20 frames of two sequences through each lens at the tiny
  Dims of ``__graft_entry__._tiny_cfg`` (the slice's fast propagation and
  square-root form), from one initial state carried across with
  ``interop``, with and without the homography outlier rejection. The
  reference draws each frame's homography uniforms from its state's key;
  ``tracker_draws`` rebuilds them (the tracker splits the key once a
  frame and nothing else in ``vio_frame`` draws) and the port takes them
  as ``hom_uniforms``. Poses, the whole state and its factor within 1e-8,
  every count of ``StepOutputs`` exactly, the rejections included.

With the rejection on, a ninth of the measurements of each frame from
frame 4 on jump 25 px (``with_outliers``, the same rows in both streams),
so that the rejection fires. With x64 on, the reference's point-cloud
tracker counts its rejections in a sum that JAX widens to int64, so the
count it carries would change dtype after the first frame and
``lax.scan`` would refuse the carry: the initial count is made int64
there; nothing else changes.

The rejection case (the equidistant lens) is in
tests/test_torch_camera_rejection.py (its own file, so that the test
workers take the runs in parallel).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_camera_models_e2e import CAMS
from test_torch_homography import N_HYPS, tracker_draws
from test_torch_pipeline import SLICE, TINY, _walk
from xivo_tpu.filter.config import config_from_json as jax_config_from_json
from xivo_tpu.filter.layout import Dims as JaxDims
from xivo_tpu.runner import batch_states as jax_batch_states
from xivo_tpu.runner import make_batch_runner as jax_batch_runner
from xivo_tpu.sim.configs import PCW_CFG as JAX_PCW_CFG
from xivo_tpu.sim.stream import build_pcw_stream as jax_stream
from xivo_tpu_torch import interop
from xivo_tpu_torch.filter.config import config_from_json
from xivo_tpu_torch.filter.layout import Dims
from xivo_tpu_torch.runner import inputs_to_device, run_batch
from xivo_tpu_torch.sim.configs import PCW_CFG
from xivo_tpu_torch.sim.stream import build_pcw_stream

torch.set_num_threads(2)
FRAMES = 20
SEEDS = (1, 2)
TOL = 1e-8


def cam_cfgs(cam, dtype="float64", dims=TINY, **over):
    """(reference config, port config): the PCW slice config at `dims`
    through camera `cam` of tests/test_camera_models_e2e.py."""
    def build(base, from_json, D):
        raw = dict(base, camera_cfg=CAMS[cam])
        return from_json(raw, dims=D(*dims), dtype=dtype, **SLICE, **over)
    return (build(JAX_PCW_CFG, jax_config_from_json, JaxDims),
            build(PCW_CFG, config_from_json, Dims))


def streams(jc, tc, frames, seeds):
    kw = dict(total_time=frames * 0.05, noise_px=0.25, use_cfg_camera=True)
    return ([jax_stream(jc, seed=sd, **kw) for sd in seeds],
            [build_pcw_stream(tc, seed=sd, **kw) for sd in seeds])


@pytest.mark.parametrize("cam", list(CAMS))
def test_cfg_camera_stream_matches_reference(cam):
    jc, tc = cam_cfgs(cam)
    [(fj, gj)], [(ft, gt)] = streams(jc, tc, 40, (3,))
    for name, a, b in zip(fj._fields, fj, ft):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if name == "meas_xp":
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-12)
        else:
            assert a.tobytes() == b.tobytes(), name
    assert ft.meas_valid.sum(axis=1).min() > 30
    for k in gj:
        assert np.asarray(gj[k]).tobytes() == np.asarray(gt[k]).tobytes(), k
    # the lens bends the measurements: not the pinhole stream's pixels
    fp, _ = build_pcw_stream(tc, total_time=40 * 0.05, noise_px=0.25,
                             seed=3)
    assert not np.array_equal(fp.meas_xp, ft.meas_xp)


def with_outliers(fi):
    """fi with a ninth of each frame's measurements from frame 4 on moved
    25 px (which rows, and the direction, from the landmark id)."""
    xp = np.array(fi.meas_xp)
    t = np.arange(xp.shape[0])[:, None]
    hit = fi.meas_valid & (t >= 4) & (fi.meas_id % 9 == t % 9)
    ang = fi.meas_id * 2.399
    xp += (25.0 * hit)[..., None] * np.stack([np.cos(ang), np.sin(ang)], -1)
    return fi._replace(meas_xp=xp.astype(fi.meas_xp.dtype))


def run_both(jc, tc, frames=FRAMES, seeds=SEEDS):
    """Both packages' runs from one initial state (each sequence its own
    key): (reference (state, outputs), port (state, outputs))."""
    js_, ts_ = streams(jc, tc, frames, seeds)
    if jc.do_outlier_rejection:
        js_ = [(with_outliers(f), g) for f, g in js_]
        ts_ = [(with_outliers(f), g) for f, g in ts_]
    B = len(seeds)
    g0 = np.stack([gt["gyro0"] for _, gt in js_])
    a0 = np.stack([gt["accel0"] for _, gt in js_])
    js = jax_batch_states(jc, B)._replace(
        last_gyro=jnp.asarray(g0), last_accel=jnp.asarray(a0),
        key=jax.random.split(jax.random.PRNGKey(9), B))
    ts = interop.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    hom = None
    if jc.do_outlier_rejection:
        keys, draws = js.key, []
        for _ in range(frames):
            keys, u = tracker_draws(keys, jc.dims.nf_rows)
            draws.append(u)
        hom = torch.tensor(np.stack(draws, 1))
        assert hom.shape == (B, frames, N_HYPS, tc.dims.nf_rows)
        js = js._replace(n_tracker_rejected=js.n_tracker_rejected.astype(
            jnp.int64))
    jfi = jax.tree.map(lambda *x: jnp.stack(x), *[f for f, _ in js_])
    tfi = type(ts_[0][0])(*(np.stack(x) for x in zip(*[f for f, _ in ts_])))
    ref = jax_batch_runner(jc)(js, jfi)
    if hom is not None:
        np.testing.assert_array_equal(np.asarray(ref[0].key),
                                      np.asarray(keys))
    port = run_batch(tc, ts, inputs_to_device(tfi, "cpu"),
                     hom_uniforms=hom)
    return ref, port


def check_run(cam, rejection):
    """Both packages through camera `cam`, rejection on or off, held to
    the module docstring's tolerances."""
    jc, tc = cam_cfgs(cam, do_outlier_rejection=rejection)
    (js, jo), (ts, to) = run_both(jc, tc)
    assert jo._fields == to._fields
    for name in jo._fields:
        a, b = np.asarray(getattr(jo, name)), getattr(to, name).numpy()
        assert a.shape == b.shape == (len(SEEDS), FRAMES) + a.shape[2:]
        if np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=TOL, err_msg=name)
    for path, d in _walk(interop.state_to_numpy(ts),
                         jax.tree.map(np.asarray, js)):
        assert d <= TOL, (path, d)
    # the run did real work: features entered the state
    assert int(np.asarray(jo.num_instate_features)[:, -1].min()) > 0
    rejected = np.asarray(jo.num_tracker_outlier_rejected)
    if rejection:
        assert rejected[:, 4:].min() > 0
    else:
        assert not rejected.any()


@pytest.mark.parametrize("cam", list(CAMS))
def test_vio_frame_through_lens_matches_reference(cam):
    check_run(cam, rejection=False)


def test_runner_draws_its_own_homography_uniforms():
    """Without an override the runner draws each frame's homography
    uniforms from its seeded generator, in the state's dtype: the same
    seed gives the same run, and the draws reach the tracker."""
    _, tc = cam_cfgs("equidistant", do_outlier_rejection=True)
    jc, _ = cam_cfgs("equidistant")
    _, ts_ = streams(jc, tc, 6, (1,))
    fi = inputs_to_device(type(ts_[0][0])(*(x[None] for x in ts_[0][0])),
                          "cpu")
    from xivo_tpu_torch.runner import batch_states
    runs = [run_batch(tc, batch_states(tc, 1, "cpu")._replace(
        last_gyro=torch.tensor(ts_[0][1]["gyro0"])[None],
        last_accel=torch.tensor(ts_[0][1]["accel0"])[None]), fi, seed=sd)[1]
        for sd in (5, 5)]
    for a, b in zip(runs[0], runs[1]):
        assert torch.equal(a, b)
    off = dataclasses.replace(tc, do_outlier_rejection=False)
    with pytest.raises(ValueError, match="hom_uniforms"):
        from xivo_tpu_torch.filter.pipeline import tracker_pointcloud
        s = batch_states(tc, 1, "cpu")
        tracker_pointcloud(tc, s, *(a[:, 0] for a in fi[4:]))
    assert not run_batch(off, batch_states(off, 1, "cpu"), fi)[1] \
        .num_tracker_outlier_rejected.any()
