"""Packed frame-input streams from the simulator (port of
``xivo_tpu/sim/stream.py``; host numpy/scipy, bit-equal to the
reference's stream for the same seeds)."""
from __future__ import annotations

import numpy as np

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


def build_pcw_stream(cfg: VIOConfig, total_time=10.0, imu_dt=0.01,
                     vision_dt=0.05, motion="gentle", n_points=600,
                     noise_px=0.5, noise_accel=1e-4, noise_gyro=1e-5,
                     seed=1, world_seed=0, imu_cap=32, meas_cap=256,
                     true_Rbc=None, true_Tbc=None, true_Cg=None,
                     true_Ca=None, true_td=0.0, true_K=None, world=None,
                     bias_walk_accel=0.0, bias_walk_gyro=0.0,
                     bias_gyro=None, bias_accel=None):
    """Simulate and pack one sequence through the pinhole camera of the
    config. Returns (FrameInputs of numpy arrays, gt dict). The ``true_*``
    arguments inject ground-truth calibration that may differ from the
    config's initial guesses (see the reference's docstring)."""
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
