"""Packed frame-input streams from the simulator (port of
``xivo_tpu/sim/stream.py``; host numpy/scipy, bit-equal to the
reference's stream for the same seeds)."""
from __future__ import annotations

import numpy as np
import torch

from ..filter.config import VIOConfig
from ..runner import pack_frame_inputs
from .imu_sim import get_imu_sim
from .pcw import RandomPCW


def _rodrigues(w) -> np.ndarray:
    """Rotation vector -> matrix in float64, the formula of geom/so3.exp."""
    w = np.asarray(w, np.float64)
    t2 = np.sum(w * w)
    if t2 < 1e-8:
        a, b = 1.0 - t2 / 6.0, 0.5 - t2 / 24.0
    else:
        t = np.sqrt(t2)
        a, b = np.sin(t) / t, (1.0 - np.cos(t)) / t2
    W = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]],
                  [-w[1], w[0], 0.0]])
    return np.eye(3) + a * W + b * (W @ W)


def cfg_projector(cfg: VIOConfig):
    """Normalized coords (N, 2) -> pixels (N, 2) through the config's
    camera model, in float64 numpy (``cam.models.project`` on the CPU)."""
    from ..cam import models as cam_mod
    kind, intrin, _ = cam_mod.intrinsics_from_vio_cfg(
        cfg, dtype=torch.float64, device="cpu")
    return lambda xn: cam_mod.project(
        kind, intrin, torch.from_numpy(np.asarray(xn, np.float64))).numpy()


def _generate_with_cfg_camera(pcw, cfg: VIOConfig, Rsc, Tsc, imw, imh,
                              noise_px_std):
    """Project world points through the config's (possibly distorted)
    camera model (the reference's ``_generate_with_cfg_camera``): the
    measurements (ids, [xp, depth]) of one frame, the world's id
    bookkeeping updated."""
    Xc = (pcw.Xs - Tsc[None, :]) @ Rsc
    z = Xc[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        xn = Xc[:, :2] / z[:, None]
    xp = cfg_projector(cfg)(xn)
    vis = (z > 0.1) & np.isfinite(xp).all(axis=1) \
        & (xp[:, 0] >= 0) & (xp[:, 1] >= 0) \
        & (xp[:, 0] <= imw) & (xp[:, 1] <= imh)
    # polynomial distortion models (radtan) fold large off-axis angles
    # back into the image; restrict to the invertible region like a real
    # lens hood would
    if cfg.cam_model == "radtan":
        vis &= np.linalg.norm(xn, axis=1) < 0.8
    if noise_px_std > 0:
        xp = xp + noise_px_std * pcw.rng.standard_normal(xp.shape)
    newly = vis & (pcw.ids < 0)
    n_new = int(newly.sum())
    pcw.ids[newly] = np.arange(pcw.next_id, pcw.next_id + n_new)
    pcw.next_id += n_new
    pcw.ids[~vis] = -1
    return pcw.ids[vis].copy(), np.concatenate(
        [xp[vis], z[vis, None]], axis=1)


# tests/test_api.py::run_short's camera: 640 x 480 pixels
RUN_SHORT_K = np.array([[275.0, 0, 320], [0, 275, 240], [0, 0, 1]])


def run_short_messages(Rbc, Tbc, T=2.0, offset=0.0, corrupt_from=None,
                       motion="gentle", n_points=300):
    """``tests/test_api.py::run_short``'s stream as the Estimator's
    messages, in delivery order: (t, "imu", gyro, accel) at 100 Hz and
    (t, "pc", ids, xp_and_depths) at 20 Hz, the points of a RandomPCW seen
    through RUN_SHORT_K from a camera at (Rbc, Tbc) on the body. Visual
    stamps are moved by `offset` off the IMU grid (co-timed messages have
    no defined order through a timestamp heap). From frame `corrupt_from`
    on, 8 tracked pixels a frame are moved by 60-90 px
    (``test_rejection_counters_wired``'s corruption)."""
    imu = get_imu_sim(motion, T=T + 1, noise_accel=0, noise_gyro=0, seed=1)
    pcw = RandomPCW([-10, 10], [-10, 10], [-5, 5], n_points=n_points,
                    seed=0)
    rng = np.random.default_rng(7)
    packets = sorted([(t, 0) for t in np.arange(0, T, 0.01)]
                     + [(t + offset, 1) for t in np.arange(0, T, 0.05)])
    out = []
    n_vis = 0
    for t, kind in packets:
        if kind == 0:
            a, g = imu.meas(t)
            out.append((t, "imu", g, a))
            continue
        Rsb, Tsb = imu.gsb(t - offset)
        ids, xpd = pcw.generate_measurements(
            Rsb @ Rbc, Rsb @ Tbc + Tsb, RUN_SHORT_K, 640, 480, 0.0)
        if corrupt_from is not None and n_vis >= corrupt_from \
                and len(xpd) > 20:
            xpd = np.array(xpd, float)
            xpd[:8, :2] += rng.uniform(60, 90, size=(8, 2))
        out.append((t, "pc", ids, xpd))
        n_vis += 1
    return out


def build_pcw_stream(cfg: VIOConfig, total_time=10.0, imu_dt=0.01,
                     vision_dt=0.05, motion="gentle", n_points=600,
                     noise_px=0.5, noise_accel=1e-4, noise_gyro=1e-5,
                     seed=1, world_seed=0, imu_cap=32, meas_cap=256,
                     true_Rbc=None, true_Tbc=None, true_Cg=None,
                     true_Ca=None, true_td=0.0, true_K=None, world=None,
                     use_cfg_camera=False, bias_walk_accel=0.0,
                     bias_walk_gyro=0.0, bias_gyro=None, bias_accel=None):
    """Simulate and pack one sequence. Returns (FrameInputs of numpy
    arrays, gt dict). The measurements come through the pinhole camera of
    the config's first four intrinsics or, with ``use_cfg_camera``,
    through the config's own camera model (distortion included). The
    ``true_*`` arguments inject ground-truth calibration that may differ
    from the config's initial guesses (see the reference's docstring)."""
    imu_kw = dict(T=total_time + 1.0, noise_accel=noise_accel,
                  noise_gyro=noise_gyro, seed=seed,
                  bias_walk_accel=bias_walk_accel,
                  bias_walk_gyro=bias_walk_gyro)
    if bias_gyro is not None:
        imu_kw["bias_gyro"] = np.asarray(bias_gyro, float)
    if bias_accel is not None:
        imu_kw["bias_accel"] = np.asarray(bias_accel, float)
    imu = get_imu_sim(motion, **imu_kw)
    if isinstance(world, str) and world == "tube":
        from .pcw import TubePCW
        path = np.stack([imu.gsb(t)[1]
                         for t in np.arange(0, total_time, 0.25)])
        pcw = TubePCW(path, n_points=max(n_points, 2000), seed=world_seed)
    elif world is not None:
        pcw = world
    else:
        pcw = RandomPCW([-10, 10], [-10, 10], [-5, 5], n_points=n_points,
                        seed=world_seed)
    rows, cols = int(cfg.cam_params[0]), int(cfg.cam_params[1])
    fx, fy, cx, cy = cfg.cam_params[2:6]
    K = np.asarray(true_K) if true_K is not None \
        else np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    Rbc = np.asarray(true_Rbc) if true_Rbc is not None \
        else _rodrigues(cfg.X_Wbc)
    Tbc = np.asarray(true_Tbc) if true_Tbc is not None \
        else np.asarray(cfg.X_Tbc)
    Cg_inv = np.linalg.inv(true_Cg) if true_Cg is not None else None
    Ca_inv = np.linalg.inv(true_Ca) if true_Ca is not None else None

    t_imu = np.arange(0, total_time, imu_dt)
    t_vis = np.arange(0, total_time, vision_dt)

    frames = []
    gt = {"t": [], "Rsb": [], "Tsb": [], "Vsb": []}
    pending = []
    t_prev = 0.0
    ii = 0
    for tv in t_vis:
        while ii < len(t_imu) and t_imu[ii] <= tv:
            t = t_imu[ii]
            if t == 0.0:
                ii += 1
                continue  # the t=0 sample seeds the state, no propagation
            a, g = imu.meas(t)
            if Cg_inv is not None:
                g = Cg_inv @ g
            if Ca_inv is not None:
                a = Ca_inv @ a
            pending.append((t - t_prev, g, a))
            t_prev = t
            ii += 1
        Rsb, Tsb = imu.gsb(tv + true_td)
        Rsc = Rsb @ Rbc
        Tsc = Rsb @ Tbc + Tsb
        if use_cfg_camera:
            ids, xpd = _generate_with_cfg_camera(pcw, cfg, Rsc, Tsc, cols,
                                                 rows, noise_px)
        else:
            ids, xpd = pcw.generate_measurements(Rsc, Tsc, K, cols, rows,
                                                 noise_px)
        frames.append(dict(imu=pending, frame_dt=max(tv - t_prev, 0.0),
                           ids=ids, xp=xpd[:, :2], depth=xpd[:, 2]))
        pending = []
        t_prev = tv
        gt["t"].append(tv)
        gt["Rsb"].append(Rsb)
        gt["Tsb"].append(Tsb)
        gt["Vsb"].append(imu.Vsb(tv))

    dtype = np.float32 if cfg.dtype == "float32" else np.float64
    fi = pack_frame_inputs(frames, imu_cap=imu_cap, meas_cap=meas_cap,
                           dtype=dtype)
    gt = {k: np.asarray(v) for k, v in gt.items()}
    gt["bg"] = np.stack([imu.bias_gyro_t(tv) for tv in t_vis])
    gt["ba"] = np.stack([imu.bias_accel_t(tv) for tv in t_vis])
    a0, g0 = imu.meas(0.0)
    gt["gyro0"], gt["accel0"] = g0, a0
    return fi, gt


def corrupt_measurements(fi, seed: int, share: float = 0.1,
                         px=(8.0, 20.0), start: int = 10):
    """A copy of the packed stream fi (leading axis T) with gross outliers
    planted: from frame `start` on, each valid measurement is moved with
    probability `share` by a uniform px[0]-px[1] pixels in a uniform
    direction, all drawn from `seed`. The tracks keep their ids, so that
    the filter, not the tracker, has to reject them."""
    rng = np.random.default_rng(seed)
    T, M = fi.meas_valid.shape
    hit = (rng.random((T, M)) < share) & fi.meas_valid \
        & (np.arange(T) >= start)[:, None]
    mag = rng.uniform(px[0], px[1], (T, M))
    ang = rng.uniform(0.0, 2.0 * np.pi, (T, M))
    step = np.stack([np.cos(ang), np.sin(ang)], -1) * mag[..., None]
    xp = np.where(hit[..., None], fi.meas_xp + step, fi.meas_xp)
    return fi._replace(meas_xp=xp.astype(fi.meas_xp.dtype))
