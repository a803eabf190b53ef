"""Synthetic ASL datasets on disk (host numpy), for the replay app and the
estimator to read back through ``io/loader.py``.

* ``write_dots_dataset``: the JAX package's ``tests/test_io.py::
  build_synthetic_asl`` (``IMG_CFG``'s 320 x 240 pinhole camera, dots of
  ``make_world(400)`` along the gentle trajectory, 100 Hz IMU, 10 Hz
  frames) in the ``<root>/seq/{cam0,imu0}`` layout, the same files;
* ``write_tumvi_dataset``: the image benchmark's world and motion
  (``sim/image_stream.py``) through a config's own lens, after a rest
  (so that gravity initialization sees one), in the TUM-VI layout
  ``<root>/dataset-room1_512_16/mav0/{cam0,imu0,mocap0}`` with mocap
  ground truth.

Images are written as ``.npy`` (float32), which needs no decoder.
Timestamps are integer nanoseconds, as the ASL csv files hold them.
"""
from __future__ import annotations

import os

import numpy as np
from scipy.spatial.transform import Rotation

from ..filter.config import VIOConfig
from .configs import make_world
from .image_stream import IMU_DT, MOTION, VIS_DT
from .imu_sim import get_imu_sim
from .render import render_dots
from .stream import _rodrigues, cfg_projector

REST_TIME = 0.6    # s at rest before the motion, as tests/test_e2e_asl.py


def _write_csv(path, header, rows):
    with open(path, "w") as f:
        f.write(header + "\n" + "\n".join(rows) + "\n")


def _imu_row(ns, g, a):
    return ",".join([str(ns)] + [f"{x:.9f}" for x in g]
                    + [f"{x:.9f}" for x in a])


def _camera(cfg: VIOConfig):
    rows, cols = int(cfg.cam_params[0]), int(cfg.cam_params[1])
    fx, fy, cx, cy = cfg.cam_params[2:6]
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    return rows, cols, K, _rodrigues(cfg.X_Wbc), np.asarray(cfg.X_Tbc)


def write_dots_dataset(root: str, cfg: VIOConfig):
    """Write ``build_synthetic_asl``'s dataset (2 s, 100 Hz IMU, 10 Hz
    frames) under `root` for the config's camera; returns the IMU
    simulator (the ground truth)."""
    T, imu_dt, vis_dt = 2.0, 0.01, 0.1
    imu = get_imu_sim("gentle", T=T + 1, noise_accel=0, noise_gyro=0,
                      seed=1)
    Xs = make_world(400, seed=2)
    rows, cols, K, Rbc, Tbc = _camera(cfg)
    cam_dir = os.path.join(root, "seq", "cam0")
    imu_dir = os.path.join(root, "seq", "imu0")
    os.makedirs(os.path.join(cam_dir, "data"))
    os.makedirs(imu_dir)
    img_rows = []
    for t in np.arange(0, T, vis_dt):
        ns = int(round(t * 1e9))
        Rsb, Tsb = imu.gsb(t)
        img = render_dots(Xs, Rsb @ Rbc, Rsb @ Tbc + Tsb, K, cols, rows)
        name = f"{ns}.npy"
        np.save(os.path.join(cam_dir, "data", name), img)
        img_rows.append(f"{ns},{name}")
    _write_csv(os.path.join(cam_dir, "data.csv"), "#ts,filename", img_rows)
    imu_rows = []
    for t in np.arange(0, T, imu_dt):
        a, g = imu.meas(t)
        imu_rows.append(_imu_row(int(round(t * 1e9)), g, a))
    _write_csv(os.path.join(imu_dir, "data.csv"), "#ts,gx,gy,gz,ax,ay,az",
               imu_rows)
    return imu


def write_tumvi_dataset(root: str, cfg: VIOConfig, n_frames: int):
    """Write `n_frames` frames of the image benchmark's stream through the
    config's lens as the TUM-VI directory of sequence "room1" under
    `root`: the body rests for REST_TIME s, then moves as the stream does
    from its start (the gentle trajectory starts at rest, so the joint is
    smooth)."""
    imu = get_imu_sim(MOTION, T=n_frames * VIS_DT + 2.0, noise_accel=1e-4,
                      noise_gyro=1e-5, seed=1)
    Xs = make_world(800, seed=2)
    rows, cols, K, Rbc, Tbc = _camera(cfg)
    project_fn = None if cfg.cam_model == "pinhole" else cfg_projector(cfg)
    base = os.path.join(root, "dataset-room1_512_16", "mav0")
    dirs = {k: os.path.join(base, k) for k in ("cam0", "imu0", "mocap0")}
    os.makedirs(os.path.join(dirs["cam0"], "data"))
    os.makedirs(dirs["imu0"])
    os.makedirs(dirs["mocap0"])

    def motion_t(t):
        return max(t - REST_TIME, 0.0)

    n_imu = int(round((REST_TIME + n_frames * VIS_DT) / IMU_DT))
    imu_rows = []
    for k in range(1, n_imu + 1):
        t = k * IMU_DT
        a, g = imu.meas(motion_t(t))
        imu_rows.append(_imu_row(int(round(t * 1e9)), g, a))
    img_rows, mocap_rows = [], []
    for k in range(1, n_frames + 1):
        t = REST_TIME + k * VIS_DT
        ns = int(round(t * 1e9))
        Rsb, Tsb = imu.gsb(motion_t(t))
        img = render_dots(Xs, Rsb @ Rbc, Rsb @ Tbc + Tsb, K, cols, rows,
                          project_fn=project_fn)
        name = f"{ns}.npy"
        np.save(os.path.join(dirs["cam0"], "data", name), img)
        img_rows.append(f"{ns},{name}")
        q = Rotation.from_matrix(Rsb).as_quat()          # x y z w
        mocap_rows.append(",".join(str(x) for x in [ns, *Tsb, *q]))
    _write_csv(os.path.join(dirs["imu0"], "data.csv"),
               "#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z", imu_rows)
    _write_csv(os.path.join(dirs["cam0"], "data.csv"),
               "#timestamp [ns],filename", img_rows)
    _write_csv(os.path.join(dirs["mocap0"], "data.csv"),
               "#timestamp [ns],px,py,pz,qx,qy,qz,qw", mocap_rows)
