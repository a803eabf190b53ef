"""The benchmark's stream generator: a frozen copy of the program's
``sim/stream.build_pcw_stream`` (the pinhole path through a
``RandomPCW``) and ``runner.pack_frame_inputs``. Host numpy and scipy
only; nothing of the program is imported.

A camera is a dict as the configuration's ``camera_cfg`` gives it
(``rows``, ``cols``, ``fx``, ``fy``, ``cx``, ``cy``); the body-to-camera
extrinsics are the configuration's ``X.Wbc`` and ``X.Tbc``. The
generator returns (inputs, gt): inputs a dict of numpy arrays named as
the program's ``FrameInputs`` fields, leading axis T; gt the poses
``Rsb`` (T, 3, 3), ``Tsb`` (T, 3) at each frame and ``gyro0``,
``accel0``, the IMU reading at t = 0 that seeds the state.
"""
from __future__ import annotations

import numpy as np

from .imu_sim import get_imu_sim
from .pcw import RandomPCW

PCW_FIELDS = ("gyro", "accel", "imu_dt", "frame_dt", "meas_id", "meas_xp",
              "meas_depth", "meas_valid")


def rodrigues(w) -> np.ndarray:
    """Rotation vector -> matrix in float64."""
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


def pack_frame_inputs(frames, imu_cap=32, meas_cap=256, dtype=np.float32):
    """Packs a measurement stream (dicts with keys imu = [(dt, gyro,
    accel)], frame_dt, ids, xp, depth); the IMU axis is trimmed to the
    most samples a frame holds."""
    T = len(frames)
    need = max((len(f["imu"]) for f in frames), default=1)
    imu_cap = max(1, min(imu_cap, need))
    gyro = np.zeros((T, imu_cap, 3), dtype)
    accel = np.zeros((T, imu_cap, 3), dtype)
    imu_dt = np.zeros((T, imu_cap), dtype)
    frame_dt = np.zeros((T,), dtype)
    meas_id = np.full((T, meas_cap), -1, np.int32)
    meas_xp = np.zeros((T, meas_cap, 2), dtype)
    meas_depth = np.full((T, meas_cap), -1.0, dtype)
    meas_valid = np.zeros((T, meas_cap), bool)
    for t, f in enumerate(frames):
        for i, (dt, gy, ac) in enumerate(f["imu"][:imu_cap]):
            imu_dt[t, i] = dt
            gyro[t, i] = gy
            accel[t, i] = ac
        frame_dt[t] = f["frame_dt"]
        n = min(len(f["ids"]), meas_cap)
        meas_id[t, :n] = f["ids"][:n]
        meas_xp[t, :n] = f["xp"][:n]
        meas_depth[t, :n] = f["depth"][:n]
        meas_valid[t, :n] = True
    return dict(zip(PCW_FIELDS, (gyro, accel, imu_dt, frame_dt, meas_id,
                                 meas_xp, meas_depth, meas_valid)))


def build_pcw_stream(cam: dict, Wbc, Tbc, total_time=10.0, imu_dt=0.01,
                     vision_dt=0.05, motion="gentle", n_points=600,
                     noise_px=0.5, noise_accel=1e-4, noise_gyro=1e-5,
                     seed=1, world_seed=0, imu_cap=32, meas_cap=256,
                     dtype=np.float32):
    """One point-cloud-world sequence through the pinhole camera of
    `cam`'s first four intrinsics."""
    imu = get_imu_sim(motion, T=total_time + 1.0, noise_accel=noise_accel,
                      noise_gyro=noise_gyro, seed=seed)
    pcw = RandomPCW([-10, 10], [-10, 10], [-5, 5], n_points=n_points,
                    seed=world_seed)
    rows, cols = int(cam["rows"]), int(cam["cols"])
    K = np.array([[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]],
                  [0, 0, 1.0]])
    Rbc = rodrigues(Wbc)
    Tbc = np.asarray(Tbc)

    t_imu = np.arange(0, total_time, imu_dt)
    t_vis = np.arange(0, total_time, vision_dt)

    frames = []
    gt = {"Rsb": [], "Tsb": []}
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
            pending.append((t - t_prev, g, a))
            t_prev = t
            ii += 1
        Rsb, Tsb = imu.gsb(tv)
        ids, xpd = pcw.generate_measurements(Rsb @ Rbc, Rsb @ Tbc + Tsb, K,
                                             cols, rows, noise_px)
        frames.append(dict(imu=pending, frame_dt=max(tv - t_prev, 0.0),
                           ids=ids, xp=xpd[:, :2], depth=xpd[:, 2]))
        pending = []
        t_prev = tv
        gt["Rsb"].append(Rsb)
        gt["Tsb"].append(Tsb)

    fi = pack_frame_inputs(frames, imu_cap=imu_cap, meas_cap=meas_cap,
                           dtype=dtype)
    gt = {k: np.asarray(v) for k, v in gt.items()}
    a0, g0 = imu.meas(0.0)
    gt["gyro0"], gt["accel0"] = g0, a0
    return fi, gt

