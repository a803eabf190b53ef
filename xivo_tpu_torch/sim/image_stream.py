"""Rendered image streams for image-mode VIO (host numpy).

The counterpart of the JAX package's image benchmark stream
(``scripts/bench_image.py::build_frames``, pinhole camera): a gentle IMU
trajectory through a random landmark cloud, one dot-rendered frame every
``VIS_DT`` seconds and the IMU samples between frames packed into a fixed
(KI,) axis. The rates, the pack width and the motion are the benchmark's
own constants. Everything stays in numpy; ``runner.image_inputs_to_device``
moves it to the device once.
"""
from __future__ import annotations

import numpy as np

from ..filter.config import VIOConfig
from ..runner import ImageInputs
from .configs import make_world
from .imu_sim import get_imu_sim
from .render import render_dots
from .stream import _rodrigues

VIS_DT, IMU_DT, KI = 0.05, 0.01, 8     # frame and IMU periods (s), IMU slots
MOTION = "gentle"


def build_image_stream(cfg: VIOConfig, total_time=6.0, n_points=800,
                       world_seed=2, seed=1, imu_T=8.0):
    """One sequence through the config's pinhole camera. Returns
    (ImageInputs of numpy arrays: gyro/accel (T, KI, 3), imu_dt (T, KI),
    frame_dt (T,), image (T, rows, cols) float32; gt dict with the poses
    Rsb (T, 3, 3) and Tsb (T, 3) at each frame, the frame times t, and
    gyro0/accel0, the IMU reading at t = 0 that seeds the state). The
    defaults are the image benchmark's stream (120 frames over 6 s)."""
    imu = get_imu_sim(MOTION, T=imu_T, noise_accel=1e-4, noise_gyro=1e-5,
                      seed=seed)
    Xs = make_world(n_points, seed=world_seed)
    rows, cols = int(cfg.cam_params[0]), int(cfg.cam_params[1])
    fx, fy, cx, cy = cfg.cam_params[2:6]
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    Rbc = _rodrigues(cfg.X_Wbc)
    Tbc = np.asarray(cfg.X_Tbc)
    dtype = np.float32 if cfg.dtype == "float32" else np.float64

    gyro, accel, dts, fdts, images = [], [], [], [], []
    gt = {"t": [], "Rsb": [], "Tsb": []}
    t_prev = 0.0
    t = VIS_DT
    while t < total_time:
        gys = np.zeros((KI, 3), dtype)
        acs = np.zeros((KI, 3), dtype)
        dt = np.zeros((KI,), dtype)
        i = 0
        ti = t_prev + IMU_DT
        while ti <= t + 1e-9 and i < KI:
            a, g = imu.meas(ti)
            gys[i], acs[i], dt[i] = g, a, IMU_DT
            ti += IMU_DT
            i += 1
        Rsb, Tsb = imu.gsb(t)
        images.append(render_dots(Xs, Rsb @ Rbc, Rsb @ Tbc + Tsb, K, cols,
                                  rows))
        gyro.append(gys)
        accel.append(acs)
        dts.append(dt)
        fdts.append(max(t - t_prev - IMU_DT * i, 0.0))
        gt["t"].append(t)
        gt["Rsb"].append(Rsb)
        gt["Tsb"].append(Tsb)
        t_prev = t
        t += VIS_DT
    fi = ImageInputs(np.stack(gyro), np.stack(accel), np.stack(dts),
                     np.asarray(fdts, dtype), np.stack(images))
    gt = {k: np.asarray(v) for k, v in gt.items()}
    a0, g0 = imu.meas(0.0)
    gt["gyro0"], gt["accel0"] = g0, a0
    return fi, gt
