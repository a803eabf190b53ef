"""IMU propagation (port of ``xivo_tpu/filter/propagate.py``), the fast
mode alone: ``propagate_interval_fast_static`` integrates one interval on
a static grid of uniform substeps (``fast_substeps``). Batched over a
leading axis B: every MotionState field carries it, and ``dt`` is (B,).
"""
from __future__ import annotations

import torch

from ..geom import so3
from ..ops.dense import constant
from . import layout as L
from .config import VIOConfig
from .state import MotionState


def mv(A, v):
    """Batched matrix-vector product (..., r, c) @ (..., c) -> (..., r)."""
    return (A @ v.unsqueeze(-1)).squeeze(-1)


def compose_motion(X: MotionState, V, gyro, accel, dt, g,
                   project: bool = True) -> MotionState:
    """Integrate the nominal state by dt (ref src/estimator.cpp:597-614);
    dt is (B,)."""
    gyro_calib = mv(X.Cg, gyro) - X.bg
    accel_calib = mv(X.Ca, accel) - X.ba
    dt1 = dt[..., None]
    Tsb = X.Tsb + V * dt1
    Vsb = X.Vsb + (mv(X.Rsb, accel_calib) + mv(X.Rsg, g)) * dt1
    Rsb = X.Rsb @ so3.exp(gyro_calib * dt1)
    if project:
        Rsb = so3.project(Rsb)
    return X._replace(Rsb=Rsb, Tsb=Tsb, Vsb=Vsb)


def motion_jacobians(X: MotionState, gyro, accel, g):
    """F (B,39,39), G (B,39,12) (Estimator::ComputeMotionJacobianAt,
    src/estimator.cpp:616-704)."""
    gyro_calib = mv(X.Cg, gyro) - X.bg
    accel_calib = mv(X.Ca, accel) - X.ba
    Rsb = X.Rsb
    B = Rsb.shape[:-2]
    kw = dict(dtype=Rsb.dtype, device=Rsb.device)

    def Z(r, c):
        return torch.zeros(B + (r, c), **kw)

    eye3 = torch.eye(3, **kw).expand(B + (3, 3))
    Z33 = Z(3, 3)
    dV_dWsg = -X.Rsg @ so3.hat(g).expand(B + (3, 3))
    dW_dCg = (torch.eye(3, **kw)[:, :, None]
              * gyro[..., None, None, :]).reshape(B + (3, 9))
    dV_dRCa = so3.dAB_dA(accel[..., :, None], 3, 3)      # (B, 3, 9)
    dRCa_dCafm = so3.dAB_dB(Rsb, 3, 3)                   # (B, 9, 9)
    dV_dCa = dV_dRCa @ dRCa_dCafm @ so3.dA_dAu(**kw)     # (B, 3, 6)

    rows_W = torch.cat([
        -so3.hat(gyro_calib), Z33, Z33, -eye3, Z33, Z33, Z33,
        Z(3, 3), dW_dCg, Z(3, 6)], dim=-1)
    rows_T = torch.cat([Z33, Z33, eye3, Z(3, L.MOTION - 9)], dim=-1)
    rows_V = torch.cat([
        -Rsb @ so3.hat(accel_calib), Z33, Z33, Z33, -Rsb, Z33, Z33,
        dV_dWsg[..., :2], Z(3, 1 + 9), dV_dCa], dim=-1)
    F = torch.cat([rows_W, rows_T, rows_V, Z(L.MOTION - 9, L.MOTION)],
                  dim=-2)

    Z312 = Z(3, 12)
    G = torch.cat([
        torch.cat([-eye3, Z33, Z33, Z33], dim=-1),
        Z312,
        torch.cat([Z33, -Rsb, Z33, Z33], dim=-1),
        torch.cat([Z33, Z33, eye3, Z33], dim=-1),
        torch.cat([Z33, Z33, Z33, eye3], dim=-1),
        Z(L.MOTION - 15, 12)], dim=-2)
    return F, G


def imu_noise(cfg: VIOConfig, dtype, device):
    """diag(Qimu^2) (12, 12)."""
    q = tuple(cfg.Qimu_gyro) + tuple(cfg.Qimu_accel) \
        + tuple(cfg.Qimu_gyro_bias) + tuple(cfg.Qimu_accel_bias)
    return torch.diag(constant(q, dtype, device) ** 2)


def propagate_interval_fast_static(cfg: VIOConfig, X: MotionState, gyro0,
                                   accel0, sg, sa, dt):
    """Static-grid fast propagation over one interval of length dt (B,):
    n = clip(ceil(dt/h0), 1, S) uniform substeps on a grid of S slots,
    inactive slots carry h = 0 and are exact no-ops. Each substep composes
    Phi_i = I + F h + (F h)^2 / 2 and Q <- Phi_i Q Phi_i^T + G Qimu G^T h.
    Rotation re-orthonormalization is left to the caller (once a frame).

    Returns (X', Phi (B,39,39), Qacc (B,39,39)).
    """
    dtype, dev = X.Tsb.dtype, X.Tsb.device
    m = L.MOTION
    g = constant(tuple(cfg.gravity), dtype, dev)
    Qimu = imu_noise(cfg, dtype, dev)
    h0 = cfg.stepsize
    S = cfg.fast_substeps
    eye = torch.eye(m, dtype=dtype, device=dev)

    n = torch.clamp(torch.ceil(dt / h0).to(torch.int64), 1, S)
    h_act = dt / n.to(dtype)

    Xc = X
    Phi = eye.expand(dt.shape + (m, m))
    Q = torch.zeros(dt.shape + (m, m), dtype=dtype, device=dev)
    gy, ac = gyro0, accel0
    for k in range(S):
        h = torch.where(k < n, h_act, torch.zeros((), dtype=dtype,
                                                  device=dev))
        h1 = h[..., None]
        gy_m = gy + sg * (0.5 * h1)
        ac_m = ac + sa * (0.5 * h1)
        Xm = compose_motion(Xc, Xc.Vsb, gy_m, ac_m, 0.5 * h, g,
                            project=False)
        F, G = motion_jacobians(Xm, gy_m, ac_m, g)
        Xc = compose_motion(Xc, Xm.Vsb, gy_m, ac_m, h, g, project=False)
        Fh = F * h[..., None, None]
        Phi_i = eye + Fh + 0.5 * (Fh @ Fh)
        Phi = Phi_i @ Phi
        Q = Phi_i @ Q @ Phi_i.transpose(-1, -2) \
            + (G @ Qimu @ G.transpose(-1, -2)) * h[..., None, None]
        gy = gy + sg * h1
        ac = ac + sa * h1
    return Xc, Phi, Q


def qmodel_diag(cfg: VIOConfig, dtype, device):
    """The diagonal of Qmodel, the extra motion-block process noise on
    Wsb/Wbc/(Tbc)/Wsg added once per propagated interval
    (src/estimator.cpp:590): (39,)."""
    m = L.MOTION
    qm = [0.0] * m
    qm[L.WSB:L.WSB + 3] = [cfg.Qmodel_Wsb ** 2] * 3
    qm[L.WBC:L.WBC + 3] = [cfg.Qmodel_Wbc ** 2] * 3
    if cfg.Qmodel_Tbc > 0:
        qm[L.TBC:L.TBC + 3] = [cfg.Qmodel_Tbc ** 2] * 3
    qm[L.WSG:L.WSG + 2] = [cfg.Qmodel_Wsg ** 2] * 2
    return constant(tuple(qm), dtype, device)
