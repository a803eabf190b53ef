"""Geometric calibration utilities (port of
``xivo_tpu/eval/geometry.py``, a numpy copy).

Ports of src/geometry.{h,cpp}: rotational hand-eye calibration (AX=XB on
SO3) and trajectory alignment, plus the Allan-variance IMU noise
identification of the reference's calibration scripts
(scripts/calibration/allan_plot.py). Host-side numpy.
"""
from __future__ import annotations

import numpy as np


def hand_eye_rotation(A_rotvecs, B_rotvecs) -> np.ndarray:
    """Solve R b_i = a_i for R in SO3 given paired rotation AXES.

    Port of HandEyeCalibration (src/geometry.cpp:15-60): stack the
    normalized rotation axes, least-squares for the 3x3 matrix, project
    to SO3 via SVD.
    """
    a = np.asarray(A_rotvecs, float)
    b = np.asarray(B_rotvecs, float)
    a = a / np.linalg.norm(a, axis=1, keepdims=True)
    b = b / np.linalg.norm(b, axis=1, keepdims=True)
    n = len(a)
    M = np.zeros((3 * n, 9))
    y = a.reshape(-1)
    for i in range(n):
        for row in range(3):
            M[3 * i + row, 3 * row:3 * row + 3] = b[i]
    x, *_ = np.linalg.lstsq(M, y, rcond=None)
    X = x.reshape(3, 3)
    U, _, Vt = np.linalg.svd(X)
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    return U @ S @ Vt


def trajectory_alignment(Y, X) -> tuple:
    """SE3 alignment Y ~= R X + T using velocity-direction rotation fit
    then translation (TrajectoryAlignment, src/geometry.cpp:66-80)."""
    Y = np.asarray(Y, float)
    X = np.asarray(X, float)
    dX = np.diff(X, axis=0)
    dY = np.diff(Y, axis=0)
    keep = (np.linalg.norm(dX, axis=1) > 0) \
        & (np.linalg.norm(dY, axis=1) > 0)
    dX = dX[keep] / np.linalg.norm(dX[keep], axis=1, keepdims=True)
    dY = dY[keep] / np.linalg.norm(dY[keep], axis=1, keepdims=True)
    W = dY.T @ dX
    U, _, Vt = np.linalg.svd(W)
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ S @ Vt
    T = Y.mean(axis=0) - R @ X.mean(axis=0)
    return R, T


def allan_deviation(samples: np.ndarray, fs: float, taus=None):
    """Overlapping Allan deviation of an IMU channel.

    The noise-identification tool of the reference's calibration
    pipeline (scripts/calibration/allan_plot.py / imu_tk glue): the
    white-noise density is the deviation at tau=1 s on the -1/2 slope;
    the bias instability sits at the curve's flat bottom.

    Returns (taus, adev).
    """
    x = np.cumsum(np.asarray(samples, float)) / fs   # integrated signal
    N = len(x)
    if taus is None:
        max_m = N // 9
        taus = np.unique(np.logspace(
            0, np.log10(max(max_m, 2)), 50).astype(int))
        taus = taus[taus >= 1]
    out_t, out_a = [], []
    for m in taus:
        if 2 * m >= N:
            break
        d = x[2 * m:] - 2 * x[m:-m] + x[:-2 * m]
        avar = np.sum(d ** 2) / (2 * (m / fs) ** 2 * (N - 2 * m))
        out_t.append(m / fs)
        out_a.append(np.sqrt(avar))
    return np.asarray(out_t), np.asarray(out_a)


def identify_noise_densities(gyro: np.ndarray, accel: np.ndarray,
                             fs: float) -> dict:
    """White-noise densities from the tau=1s point of the Allan curve."""
    out = {}
    for name, sig in [("gyro", gyro), ("accel", accel)]:
        dens = []
        for k in range(3):
            taus, adev = allan_deviation(sig[:, k], fs)
            i = int(np.argmin(np.abs(taus - 1.0)))
            dens.append(adev[i])
        out[name + "_noise_density"] = np.asarray(dens)
    return out
