"""The port's ``Estimator`` against the port's batch runners at B = 1 with
their default seed, bit for bit, float64 on the CPU at the tiny Dims.

The estimator draws the homography RANSAC's uniforms and loop closure's
P3P uniforms from one ``torch.Generator`` seeded as the runners', in
their order
(``runner.run_batch_mapped``, ``runner.run_batch_image``). Each case
feeds the estimator a message stream, keeps the inputs it packs for each
frame and its state just before its first frame, and runs the same
frames through the runner from that state: the step outputs' poses and
the closure rows at every frame, and the final state and map, are equal
bit for bit.

* ``mapped``: the point-cloud path with ``use_mapper`` (keyframes every 8
  frames, closures from frame ~27 on the "loop" trajectory) and
  homography outlier rejection, 30 frames, against ``run_batch_mapped``;
* ``image`` and ``image_mapped``: ``IMG_CFG``'s rendered dots (320 x 240)
  with outlier rejection, 8 frames, against ``run_batch_image`` and
  ``run_batch_image_mapped``.
"""
import numpy as np
import pytest
import torch

from xivo_tpu_torch.api import Estimator
from xivo_tpu_torch.filter.config import config_from_json
from xivo_tpu_torch.filter.layout import Dims
from xivo_tpu_torch.filter.state import tree_map
from xivo_tpu_torch.runner import (FrameInputs, ImageInputs, batch_maps,
                                   batch_frontend_states, inputs_to_device,
                                   pack_frame_inputs,
                                   run_batch_image, run_batch_image_mapped,
                                   run_batch_mapped)
from xivo_tpu_torch.sim.configs import IMG_CFG, make_world
from xivo_tpu_torch.sim.imu_sim import get_imu_sim
from xivo_tpu_torch.sim.render import render_dots

from test_torch_api import SQRT, cfgs, feed, messages
from test_torch_pipeline import TINY

torch.set_num_threads(2)
MAPPER = dict(use_mapper=True, lc_keyframe_every=8, lc_min_age_frames=20,
              lc_nn_dist_thresh=5, lc_min_matches=5, X_Vsb=(0.9, 0.0, 0.45),
              map_merge_on_retire=False)


def capture(est, image=False):
    """Record what the estimator packs for each frame, its state before
    its first frame, and each frame's step outputs (the pose before loop
    closure, as the runners' outputs hold it) and closure rows."""
    got = dict(imu=[], meas=[], image=[], pose=[], n_lc=[], start=None)
    pack_imu, pack_meas = est._pack_imu, est._pack_meas
    name = "_run_image_frame" if image else "_run_frame"
    run = getattr(est, name)

    def rec_imu(*a):
        got["imu"].append(pack_imu(*a))
        return got["imu"][-1]

    def rec_meas(*a):
        got["meas"].append(pack_meas(*a))
        return got["meas"][-1]

    def rec_run(ts, imu, x, *rest):
        if got["start"] is None:
            got["start"] = tree_map(torch.clone, est.state)
        if image:
            got["image"].append(x)
        run(ts, imu, x, *rest)
        o = est._last_out
        got["pose"].append((o.Rsb[0].numpy(), o.Tsb[0].numpy()))
        got["n_lc"].append(est.num_loop_closure_rows())
    est._pack_imu, est._pack_meas = rec_imu, rec_meas
    setattr(est, name, rec_run)
    return got


def pc_inputs(got):
    """The frames the estimator ran, packed as the runner packs them."""
    frames = []
    for (gyro, accel, dts, frame_dt), (mid, mxp, mdepth, mvalid) in zip(
            got["imu"], got["meas"]):
        n = int(mvalid.sum())
        frames.append(dict(imu=list(zip(dts, gyro, accel)),
                           frame_dt=frame_dt, ids=mid[:n], xp=mxp[:n],
                           depth=mdepth[:n]))
    fi = pack_frame_inputs(frames, dtype=np.float64)
    return inputs_to_device(FrameInputs(*(a[None] for a in fi)), "cpu")


def image_inputs(got):
    k = max(len(i[2]) for i in got["imu"])

    def pad(a):
        return np.pad(a, [(0, k - len(a))] + [(0, 0)] * (a.ndim - 1))
    fi = ImageInputs(np.stack([pad(i[0]) for i in got["imu"]]),
                     np.stack([pad(i[1]) for i in got["imu"]]),
                     np.stack([pad(i[2]) for i in got["imu"]]),
                     np.asarray([i[3] for i in got["imu"]]),
                     np.stack(got["image"]))
    return ImageInputs(*(torch.from_numpy(a[None]) for a in fi))


def image_messages(tc, n_frames, vis_dt=0.05, imu_dt=0.01):
    """Rendered-dot frames of a gentle trajectory through IMG_CFG's
    camera, with the IMU samples between them."""
    imu = get_imu_sim("gentle", T=3.0, noise_accel=0, noise_gyro=0, seed=1)
    Xs = make_world(400, seed=2)
    rows, cols = int(tc.cam_params[0]), int(tc.cam_params[1])
    fx, fy, cx, cy = tc.cam_params[2:6]
    Kc = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    Rbc, Tbc = Estimator(tc, device="cpu").gbc()
    out = []
    for i in range(int(round(n_frames * vis_dt / imu_dt))):
        t = i * imu_dt
        a, g = imu.meas(t)
        out.append((t, "imu", g, a))
        if i % int(round(vis_dt / imu_dt)) == 0:
            Rsb, Tsb = imu.gsb(t)
            out.append((t, "image", render_dots(
                Xs, Rsb @ Rbc, Rsb @ Tbc + Tsb, Kc, cols, rows), None))
    return out


def assert_equal_runs(est, got, outs, n_lc, s, ms):
    assert len(got["pose"]) == outs.Tsb.shape[1]
    for t, (R, T) in enumerate(got["pose"]):
        np.testing.assert_array_equal(T, outs.Tsb[0, t].numpy())
        np.testing.assert_array_equal(R, outs.Rsb[0, t].numpy())
    if n_lc is not None:
        assert got["n_lc"] == n_lc[0].tolist()
        assert torch.equal(est._map.count, ms.count)
        assert torch.equal(est._map.Xs, ms.Xs)
    assert torch.equal(est.state.P, s.P)
    assert torch.equal(est.state.features.fid, s.features.fid)
    assert est.num_instate_features() == int(outs.num_instate_features[0, -1])


def test_mapped_estimator_matches_runner():
    tc = cfgs(**SQRT, **MAPPER, do_outlier_rejection=True)[1]
    est = Estimator(tc, device="cpu")
    got = capture(est)
    feed(est, messages(tc, T=1.5, motion="loop", n_points=600))
    s, ms, outs, n_lc = run_batch_mapped(
        tc, got["start"], batch_maps(tc.map_capacity, 1, "cpu",
                                     torch.float64),
        pc_inputs(got))
    assert est.num_tracker_outlier_rejected() >= 0
    assert sum(got["n_lc"]) > 0, "no loop closed"
    assert_equal_runs(est, got, outs, n_lc, s, ms)


@pytest.mark.parametrize("mapped", [False, True],
                         ids=["image", "image_mapped"])
def test_image_estimator_matches_runner(mapped):
    raw = dict(IMG_CFG)
    raw.pop("max_depth_var_for_admission")
    over = dict(SQRT, do_outlier_rejection=True)
    if mapped:
        over.update(MAPPER, X_Vsb=(0.0, 0.0, 0.0), lc_min_age_frames=4,
                    lc_keyframe_every=2)
    tc = config_from_json(raw, dims=Dims(*TINY), dtype="float64", **over)
    est = Estimator(tc, device="cpu")
    got = capture(est, image=True)
    for t, kind, a, b in image_messages(tc, 8):
        if kind == "imu":
            est.InertialMeas(t, a, b)
        else:
            est.VisualMeas(t, a)
    fes = batch_frontend_states(tc, 1, "cpu")
    fi = image_inputs(got)
    if mapped:
        s, _, ms, outs, n_lc = run_batch_image_mapped(
            tc, got["start"], fes, batch_maps(tc.map_capacity, 1, "cpu",
                                              torch.float64), fi)
    else:
        (s, _, outs), ms, n_lc = run_batch_image(
            tc, got["start"], fes, fi), None, None
    assert int(outs.num_tracked[0, -1]) > 10
    assert_equal_runs(est, got, outs, n_lc, s, ms)
