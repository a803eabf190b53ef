"""Fully batched frame propagation, ``propagation_mode="batched"`` (port
of ``xivo_tpu/filter/propagate_batched.py``), for the full covariance
form, which that mode requires.

Every substep of a frame lies on a static grid of ``cfg.total_substeps``
slots: interval i (the frame's IMU intervals, then the segment to the
frame time) takes n_i = clip(ceil(dt_i / h0), 1, cfg.max_substeps)
uniform substeps, packed one after another; empty slots carry h = 0 and
are exact no-ops (dR = I, Phi = I, Q = 0).

1. The substeps' midpoint gyro / accel readings (the reference's linear
   interpolation, src/estimator.cpp:558-567) in one batched evaluation.
2. The rotation trajectory: exclusive prefix products of exp(w_k h_k) by a
   log-depth (Hillis-Steele) scan of batched 3 x 3 products.
3. Velocity and position by the midpoint rule, with cumulative sums.
4. The covariance transition: Phi_k = I + F_k h + (F_k h)^2 / 2 and
   Q_k = G_k Qimu G_k^T h from one batched Jacobian evaluation, composed
   by the pair rule (Phi, Q)_a then (Phi, Q)_b = (Phi_b Phi_a,
   Phi_b Q_a Phi_b^T + Q_b) in a log-depth pairwise reduction (the
   reference's ``associative_scan``, of which it reads the last element),
   then applied to P once.

Torch has no associative scan, so both are written out as explicit
batched products; they agree with the reference's to rounding. No kernel
of the port runs here: everything is dense batched PyTorch.
"""
from __future__ import annotations

import torch

from ..geom import so3
from ..ops.dense import constant, take_rows
from . import layout as L
from .config import VIOConfig
from .features import bcast_X
from .propagate import imu_noise, motion_jacobians, mv, with_motion_block
from .state import VIOState


def _prefix_products(dR):
    """Inclusive prefix products along axis 1 of (B, K, 3, 3): element k is
    dR_0 dR_1 ... dR_k, in ceil(log2 K) rounds of batched products."""
    out, off, K = dR, 1, dR.shape[1]
    while off < K:
        out = torch.cat([out[:, :off], out[:, :-off] @ out[:, off:]], dim=1)
        off *= 2
    return out


def _compose_transitions(Phi, Q):
    """(Phi_tot, Q_tot) of the chain of K per-substep transitions (B, K, m,
    m), first to last, by pairwise reduction (log-depth): the pair (a, b)
    composes to (Phi_b Phi_a, Phi_b Q_a Phi_b^T + Q_b)."""
    while Phi.shape[1] > 1:
        if Phi.shape[1] % 2:
            eye = torch.eye(Phi.shape[-1], dtype=Phi.dtype,
                            device=Phi.device)
            Phi = torch.cat([Phi, eye.expand(Phi[:, :1].shape)], dim=1)
            Q = torch.cat([Q, torch.zeros_like(Q[:, :1])], dim=1)
        Pa, Pb, Qa, Qb = Phi[:, 0::2], Phi[:, 1::2], Q[:, 0::2], Q[:, 1::2]
        Phi = Pb @ Pa
        Q = Pb @ Qa @ Pb.transpose(-1, -2) + Qb
    return Phi[:, 0], Q[:, 0]


def propagate_frame_batched(cfg: VIOConfig, s: VIOState, imu_gyro,
                            imu_accel, imu_dt, dt_eff) -> VIOState:
    """imu_* (B, KI, ...), dt_eff (B,); rows with dt <= 0 are padding."""
    dtype, dev = s.P.dtype, s.P.device
    m = L.MOTION
    B, KI = imu_dt.shape
    K = cfg.total_substeps
    g = constant(tuple(cfg.gravity), dtype, dev)
    X = s.X

    # interval table: the KI sample intervals, then the frame segment
    dts = torch.cat([imu_dt, dt_eff[:, None]], dim=1)       # (B, KI+1)
    zero3 = torch.zeros((B, 1, 3), dtype=dtype, device=dev)
    g_start = torch.cat([s.last_gyro[:, None], imu_gyro], dim=1)
    a_start = torch.cat([s.last_accel[:, None], imu_accel], dim=1)
    safe = torch.clamp(dts, min=1e-12)[..., None]
    slope_g = (torch.cat([imu_gyro, zero3], 1) - g_start) / safe
    slope_a = (torch.cat([imu_accel, zero3], 1) - a_start) / safe
    # the frame segment extrapolates from the last valid sample with its
    # slope
    n_valid = torch.sum((dts[:, :KI] > 0).to(torch.int64), dim=-1)
    last = torch.clamp(n_valid - 1, 0, KI - 1)[:, None]
    has = (n_valid > 0)[:, None]
    sg_frame = torch.where(has, take_rows(slope_g, last)[:, 0], s.slope_gyro)
    sa_frame = torch.where(has, take_rows(slope_a, last)[:, 0],
                           s.slope_accel)
    g_last = torch.where(has, take_rows(imu_gyro, last)[:, 0], s.last_gyro)
    a_last = torch.where(has, take_rows(imu_accel, last)[:, 0],
                         s.last_accel)
    slope_g = torch.cat([slope_g[:, :KI], sg_frame[:, None]], dim=1)
    slope_a = torch.cat([slope_a[:, :KI], sa_frame[:, None]], dim=1)
    g_start = torch.cat([g_start[:, :KI], g_last[:, None]], dim=1)
    a_start = torch.cat([a_start[:, :KI], a_last[:, None]], dim=1)

    # substep counts per interval, packed onto the grid of K slots: slot k
    # belongs to the interval whose cumulative count range holds it
    n_sub = torch.clamp(torch.ceil(dts / cfg.stepsize).to(torch.int64), 1,
                        cfg.max_substeps)
    n_sub = torch.where(dts > 0, n_sub, 0)
    h_i = torch.where(n_sub > 0, dts / torch.clamp(n_sub, min=1).to(dtype),
                      0.0)
    starts = torch.cat([torch.zeros_like(n_sub[:, :1]),
                        torch.cumsum(n_sub, dim=-1)], dim=-1)  # (B, KI+2)
    ks = torch.arange(K, device=dev).expand(B, K).contiguous()
    itv = torch.clamp(torch.searchsorted(starts, ks, right=True) - 1, 0, KI)
    local = ks - take_rows(starts[..., None], itv)[..., 0]
    valid = ks < starts[:, -1:]
    h_k = take_rows(h_i[..., None], itv)[..., 0]
    h = torch.where(valid, h_k, 0.0)                        # (B, K)
    t_mid = (local.to(dtype) + 0.5) * h_k
    gyro_mid = take_rows(g_start, itv) + take_rows(slope_g, itv) \
        * t_mid[..., None]
    accel_mid = take_rows(a_start, itv) + take_rows(slope_a, itv) \
        * t_mid[..., None]

    # calibrated increments and the rotation prefix products: R at each
    # substep's start
    w = gyro_mid @ X.Cg.transpose(-1, -2) - X.bg[:, None]
    a_cal = accel_mid @ X.Ca.transpose(-1, -2) - X.ba[:, None]
    prods = _prefix_products(so3.exp(w * h[..., None]))    # (B, K, 3, 3)
    eye3 = torch.eye(3, dtype=dtype, device=dev).expand(B, 1, 3, 3)
    R_start = X.Rsb[:, None] @ torch.cat([eye3, prods[:, :-1]], dim=1)
    R_half = torch.where((h > 0)[..., None, None],
                         R_start @ so3.exp(w * (0.5 * h)[..., None]),
                         R_start)

    # velocity and position (midpoint rule)
    dV = (mv(R_half, a_cal) + g) * h[..., None]
    V_start = X.Vsb[:, None] + torch.cat(
        [zero3, torch.cumsum(dV[:, :-1], dim=1)], dim=1)
    dT = (V_start + 0.5 * dV) * h[..., None]
    V_end = X.Vsb + torch.sum(dV, dim=1)
    T_end = X.Tsb + torch.sum(dT, dim=1)
    R_end = so3.project(X.Rsb @ prods[:, -1])

    # the covariance transition from one batched Jacobian evaluation
    F, G = motion_jacobians(bcast_X(X)._replace(Rsb=R_half), gyro_mid,
                            accel_mid, g)
    Fh = F * h[..., None, None]
    Phi = torch.eye(m, dtype=dtype, device=dev) + Fh + 0.5 * (Fh @ Fh)
    Qk = G @ imu_noise(cfg, dtype, dev) @ G.transpose(-1, -2) \
        * h[..., None, None]
    Phi_f, Q_f = _compose_transitions(Phi, Qk)

    # Qmodel once per propagated interval (this mode's: no Tbc term)
    qm = [0.0] * m
    qm[L.WSB:L.WSB + 3] = [cfg.Qmodel_Wsb ** 2] * 3
    qm[L.WBC:L.WBC + 3] = [cfg.Qmodel_Wbc ** 2] * 3
    qm[L.WSG:L.WSG + 2] = [cfg.Qmodel_Wsg ** 2] * 2
    nprop = torch.sum((dts > 0).to(dtype), dim=-1)
    Pmm = Phi_f @ s.P[:, :m, :m] @ Phi_f.transpose(-1, -2) + Q_f \
        + nprop[:, None, None] * torch.diag(constant(tuple(qm), dtype, dev))
    P = with_motion_block(s.P, 0.5 * (Pmm + Pmm.transpose(-1, -2)),
                          Phi_f @ s.P[:, :m, m:])

    # the next frame's interpolation state
    lg = g_last + sg_frame * dt_eff[:, None]
    la = a_last + sa_frame * dt_eff[:, None]
    return s._replace(X=X._replace(Rsb=R_end, Tsb=T_end, Vsb=V_end), P=P,
                      last_gyro=lg.to(dtype), last_accel=la.to(dtype),
                      slope_gyro=sg_frame.to(dtype),
                      slope_accel=sa_frame.to(dtype))
