"""Synthetic IMU simulation with exact ground truth (a frozen copy of the
program's ``sim/imu_sim.py``: ``IMUSim`` and the "gentle" trajectory).

Re-implementation of the reference's simulator (scripts/imu_sim.py,
scripts/imu_trajectories.py): a body trajectory defined by spatial-frame
acceleration + body-frame angular velocity, integrated on the host with
scipy (ground truth), sampled into noisy accel/gyro measurements
(specific force: a_meas = a_body + bias + noise - Rsb^T g).

Host-side numpy by design — data generation is not on the device hot path.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
from numpy.random import default_rng
from scipy.integrate import solve_ivp
from scipy.interpolate import interp1d
from scipy.spatial.transform import Rotation


def _qdot(q, w):
    """Quaternion derivative (x,y,z,w convention) for body rates w."""
    x, y, z, s = q
    Q = 0.5 * np.array([
        [s, -z, y],
        [z, s, -x],
        [-y, x, s],
        [-x, -y, -z],
    ])
    return Q @ w


class IMUSim:
    """Trajectory with closed-form spatial accel + body gyro rates.

    accel_s_fn(t) -> (3,) spatial acceleration; gyro_fn(t) -> (3,) body
    angular velocity. Parity: IMUSimBase (scripts/imu_sim.py:203-277).
    """

    def __init__(self, accel_s_fn: Callable, gyro_fn: Callable,
                 T: float = 100.0, noise_accel: float = 1e-4,
                 noise_gyro: float = 1e-5,
                 bias_accel=np.zeros(3), bias_gyro=np.zeros(3),
                 seed=None, grav_s=np.array([0.0, 0.0, -9.8]),
                 init_Vsb=np.zeros(3),
                 bias_walk_accel: float = 0.0,
                 bias_walk_gyro: float = 0.0,
                 Cg_true=None, Ca_true=None):
        """bias_walk_*: random-walk intensity (units/sqrt(s)) — biases
        become Wiener processes around their initial values, matching
        the filter's own Qimu gyro_bias/accel_bias model (the
        reference models it at src/estimator.cpp:324-331; the round-4
        sim only had white noise + CONSTANT bias, so drift sat at the
        noise floor and online calibration was only ever tested
        against statics — round-4 verdict missing #3).

        Cg_true / Ca_true: optional true IMU intrinsics. Our filter
        convention is calib = C @ raw - bias, so raw measurements are
        generated as C^-1 @ (true + bias(t)) + noise (identity C and
        constant bias reduce to the legacy model exactly)."""
        self.accel_s_fn = accel_s_fn
        self.gyro_fn = gyro_fn
        self.noise_accel = noise_accel
        self.noise_gyro = noise_gyro
        self.bias_accel = np.asarray(bias_accel, float)
        self.bias_gyro = np.asarray(bias_gyro, float)
        self.rng = default_rng(seed)
        self.grav_s = np.asarray(grav_s, float)
        self.T = T
        self.Cg_true = None if Cg_true is None else np.asarray(Cg_true,
                                                               float)
        self.Ca_true = None if Ca_true is None else np.asarray(Ca_true,
                                                               float)
        # pre-generate the bias walks on a fixed grid so bias(t) is a
        # deterministic function of t (meas() may be called on any grid
        # and repeatedly)
        self._walk_dt = 0.005
        n = int(np.ceil(T / self._walk_dt)) + 2
        tw = np.arange(n) * self._walk_dt
        sq = np.sqrt(self._walk_dt)

        def walk(sigma):
            if sigma <= 0.0:
                return None
            steps = sigma * sq * self.rng.standard_normal((n, 3))
            steps[0] = 0.0
            return interp1d(tw, np.cumsum(steps, axis=0), axis=0,
                            fill_value="extrapolate")
        self._walk_g = walk(bias_walk_gyro)
        self._walk_a = walk(bias_walk_accel)

        def dX_dt(t, X):
            q = X[:4]
            V = X[7:10]
            dq = _qdot(q / np.linalg.norm(q), self.gyro_fn(t))
            return np.concatenate([dq, V, self.accel_s_fn(t)])

        ic = np.concatenate([[0, 0, 0, 1.0], np.zeros(3), init_Vsb])
        out = solve_ivp(dX_dt, [0, T], ic, t_eval=np.arange(0.0, T, 0.001),
                        rtol=1e-10, atol=1e-10)
        self.t = out.t
        self._interp = interp1d(out.t, out.y, fill_value="extrapolate")

    def gsb(self, t) -> Tuple[np.ndarray, np.ndarray]:
        X = self._interp(t)
        q = X[:4] / np.linalg.norm(X[:4])
        return Rotation.from_quat(q).as_matrix(), X[4:7]

    def Vsb(self, t) -> np.ndarray:
        return self._interp(t)[7:10]

    def bias_gyro_t(self, t) -> np.ndarray:
        """True gyro bias at time t (constant + random walk)."""
        b = self.bias_gyro
        return b + self._walk_g(t) if self._walk_g is not None else b

    def bias_accel_t(self, t) -> np.ndarray:
        """True accel bias at time t (constant + random walk)."""
        b = self.bias_accel
        return b + self._walk_a(t) if self._walk_a is not None else b

    def meas(self, t) -> Tuple[np.ndarray, np.ndarray]:
        """Noisy RAW (accel, gyro) measurement at time t.

        Filter convention calib = C @ raw - bias, so
        raw = C^-1 @ (true + bias(t)) + white noise; C=I and constant
        bias give the legacy additive model exactly."""
        Rsb, _ = self.gsb(t)
        accel_b = Rsb.T @ self.accel_s_fn(t)
        gyro = self.gyro_fn(t)
        a_true = accel_b - Rsb.T @ self.grav_s     # specific force
        a = a_true + self.bias_accel_t(t)
        g = gyro + self.bias_gyro_t(t)
        if self.Ca_true is not None:
            a = np.linalg.solve(self.Ca_true, a)
        if self.Cg_true is not None:
            g = np.linalg.solve(self.Cg_true, g)
        a = a + self.noise_accel * self.rng.standard_normal(3)
        g = g + self.noise_gyro * self.rng.standard_normal(3)
        return a, g


def get_imu_sim(motion_type: str = "gentle", **kw) -> IMUSim:
    """The named trajectory (scripts/imu_trajectories.py's closed forms);
    the benchmark's traffic runs "gentle" alone."""
    if motion_type == "gentle":
        # a slow, well-excited trajectory that STARTS AT REST (matching the
        # reference's pose-interpolation sims and the X.Vsb=[0,0,0] config
        # convention of cfg/pcw.json): sine-only accelerations integrate to
        # zero initial velocity.
        def accel_s(t):
            return np.array([0.45 * np.sin(0.9 * t),
                             -0.60 * np.sin(0.7 * t),
                             0.35 * np.sin(1.1 * t)])

        def gyro(t):
            return np.array([0.12 * np.sin(0.4 * t), 0.10 * np.sin(0.5 * t),
                             0.08 * np.sin(0.3 * t)])
        kw.setdefault("init_Vsb", np.zeros(3))
        return IMUSim(accel_s, gyro, **kw)
    raise ValueError(f"unknown motion type {motion_type}")
