"""IMU propagation (port of ``xivo_tpu/filter/propagate.py``).

Batched over a leading axis B: every MotionState field carries it, and
``dt`` is (B,). Three integrators, as in the reference:

* ``propagate_interval_fast_static`` (``propagation_mode="fast"`` with
  ``fast_substeps > 0``): a static grid of uniform substeps;
* ``propagate_interval_fast`` (``fast_substeps=0``): fixed h0 with the
  half-step trick until the interval is covered;
* ``propagate_interval`` (``propagation_mode="reference"``): the joint
  X/F/P Prince-Dormand 4(5) or RK4 substeps, with adaptive Prince-Dormand
  steps under ``pd_control_stepsize``.

The last two are ``lax.while_loop``s in the reference whose trip count
depends on dt (and, adaptive, on the data); under its ``vmap`` they run
until every sequence is done. Here they run ``cfg.max_substeps`` masked
iterations: a sequence whose interval is covered keeps its carry
(``where_state``), so nothing waits for the device to learn when all are
done. An interval the cap leaves unfinished is counted on the device
(``substep_counts``), as is the most substeps any interval took; the
runners read both once after the frame loop and raise on an unfinished
interval (``check_substeps``). ``runner.fit_substeps`` sizes the cap from
a packed stream's intervals.
"""
from __future__ import annotations

import torch

from ..geom import so3
from ..ops.dense import constant
from . import layout as L
from .config import VIOConfig
from .state import MotionState, VIOState, where_state


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


def oc_correct_phi(cfg: VIOConfig, Phi, X_new: MotionState, oc_R, oc_V,
                   oc_T, Rsg):
    """Observability-constrained transition correction (OC-EKF, Hesch et
    al., TRO'13): make the yaw-about-gravity direction n_k = (R_k^T g,
    g x T_k, g x V_k, 0, ...) propagate exactly along the prior-estimate
    chain, Phi n_k = n_{k+1}, by the minimum-Frobenius-norm update
    A <- A - (A u - w) u^T / (u^T u) of the W columns of the W, V and T
    rows. (oc_R, oc_V, oc_T): last frame's end-of-propagation estimate,
    X_new this frame's; Phi (B, 39, 39)."""
    dtype = Phi.dtype
    gs = mv(Rsg, constant(tuple(cfg.gravity), dtype, Phi.device))
    ghat = gs / (torch.linalg.vector_norm(gs, dim=-1, keepdim=True) + 1e-20)
    u = mv(oc_R.transpose(-1, -2), ghat)
    uu = torch.sum(u * u, dim=-1) + 1e-20
    hg = so3.hat(ghat)
    W, T, V = L.WSB, L.TSB, L.VSB

    def fix(A, w):
        return A - (mv(A, u) - w)[..., :, None] * u[..., None, :] \
            / uu[..., None, None]

    Phi = Phi.clone()
    Phi[:, W:W + 3, W:W + 3] = fix(Phi[:, W:W + 3, W:W + 3],
                                   mv(X_new.Rsb.transpose(-1, -2), ghat))
    wV = mv(hg, X_new.Vsb) - mv(Phi[:, V:V + 3, V:V + 3], mv(hg, oc_V))
    Phi[:, V:V + 3, W:W + 3] = fix(Phi[:, V:V + 3, W:W + 3], wV)
    wT = (mv(hg, X_new.Tsb) - mv(Phi[:, T:T + 3, T:T + 3], mv(hg, oc_T))
          - mv(Phi[:, T:T + 3, V:V + 3], mv(hg, oc_V)))
    Phi[:, T:T + 3, W:W + 3] = fix(Phi[:, T:T + 3, W:W + 3], wT)
    return Phi


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


def with_motion_block(P, Pmm, Pms):
    """The dense (B, D, D) P with its motion rows and columns replaced:
    P[:m, :m] = Pmm, P[:m, m:] = Pms, P[m:, :m] = Pms^T."""
    m = L.MOTION
    return torch.cat([torch.cat([Pmm, Pms], dim=-1),
                      torch.cat([Pms.transpose(-1, -2), P[:, m:, m:]],
                                dim=-1)], dim=-2)


# ---------------------------------------------------------------------------
# the substep loops and their counters
# ---------------------------------------------------------------------------

_COUNTS = {}


def _device_key(device):
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def substep_counts(device):
    """The device's two int64 counters (unfinished, most): the intervals
    that ``cfg.max_substeps`` left unfinished, and the most substeps an
    interval took, since the last ``reset_substep_counts``."""
    key = _device_key(device)
    if key not in _COUNTS:
        _COUNTS[key] = (torch.zeros((), dtype=torch.int64, device=key),
                        torch.zeros((), dtype=torch.int64, device=key))
    return _COUNTS[key]


def reset_substep_counts(device):
    for c in substep_counts(device):
        c.zero_()


def check_substeps(device) -> int:
    """Read the counters (one host sync) and raise if an interval was left
    unfinished; returns the most substeps an interval took."""
    unfinished, most = (int(c) for c in substep_counts(device))
    if unfinished:
        raise RuntimeError(
            f"{unfinished} propagation intervals were left unfinished by "
            "the substep cap: raise VIOConfig.max_substeps (or size it with "
            "runner.fit_substeps)")
    return most


def uses_substep_loop(cfg: VIOConfig) -> bool:
    """Whether the config propagates through the capped substep loops
    ("batched" lays its substeps on a static grid of its own)."""
    return cfg.propagation_mode == "reference" or (
        cfg.propagation_mode == "fast" and cfg.fast_substeps <= 0)


def _run_until(cfg: VIOConfig, dt, carry, step):
    """The reference's ``while total < dt: carry = step(carry)`` for B
    sequences at once: cfg.max_substeps iterations, each sequence's carry
    kept where its interval is already covered. ``carry[0]`` is the time
    integrated so far (B,); ``step`` returns the next carry."""
    steps = torch.zeros(dt.shape, dtype=torch.int64, device=dt.device)
    for _ in range(cfg.max_substeps):
        go = carry[0] < dt
        carry = where_state(go, step(carry), carry)
        steps = steps + go.to(torch.int64)
    unfinished, most = substep_counts(dt.device)
    unfinished.add_(torch.sum((carry[0] < dt).to(torch.int64)))
    torch.maximum(most, torch.amax(steps), out=most)
    return carry


def _fixed_step(h0, rem):
    """h0, or the remainder, halved when 1.5 steps would overshoot (the
    half-step trick, src/princedormand.cpp:60-81)."""
    h = torch.clamp(rem, max=h0)
    return torch.where((rem > h0) & (rem < 1.5 * h0),
                       torch.full_like(rem, 0.5 * h0), h)


def propagate_interval_fast(cfg: VIOConfig, X: MotionState, gyro0, accel0,
                            sg, sa, dt):
    """Fast propagation at ``fast_substeps=0``: fixed h0 with the half-step
    trick until dt (B,) is covered, each substep composing
    Phi_i = I + F h + (F h)^2 / 2 and Q <- Phi_i Q Phi_i^T + G Qimu G^T h,
    with the rotation projected every substep.

    Returns (X', Phi (B,39,39), Qacc (B,39,39))."""
    dtype, dev = X.Tsb.dtype, X.Tsb.device
    m = L.MOTION
    g = constant(tuple(cfg.gravity), dtype, dev)
    Qimu = imu_noise(cfg, dtype, dev)
    h0 = cfg.stepsize
    eye = torch.eye(m, dtype=dtype, device=dev)

    def step(c):
        total, X, Phi, Q, gy, ac = c
        h = _fixed_step(h0, dt - total)
        h1 = h[..., None]
        gy_m = gy + sg * (0.5 * h1)
        ac_m = ac + sa * (0.5 * h1)
        Xm = compose_motion(X, X.Vsb, gy_m, ac_m, 0.5 * h, g)
        F, G = motion_jacobians(Xm, gy_m, ac_m, g)
        Xn = compose_motion(X, Xm.Vsb, gy_m, ac_m, h, g)
        Fh = F * h[..., None, None]
        Phi_i = eye + Fh + 0.5 * (Fh @ Fh)
        Qi = (G @ Qimu @ G.transpose(-1, -2)) * h[..., None, None]
        return (total + h, Xn, Phi_i @ Phi,
                Phi_i @ Q @ Phi_i.transpose(-1, -2) + Qi, gy + sg * h1,
                ac + sa * h1)

    zero = torch.zeros(dt.shape + (m, m), dtype=dtype, device=dev)
    _, X, Phi, Q, _, _ = _run_until(cfg, dt, (
        torch.zeros(dt.shape, dtype=dtype, device=dev), X,
        eye.expand(dt.shape + (m, m)), zero,
        gyro0, accel0), step)
    return X, Phi, Q


# ---------------------------------------------------------------------------
# the reference integrators (joint X/F/P substeps)
# ---------------------------------------------------------------------------

def _stage_P(F, G, P0, Qimu):
    return F @ P0 + P0 @ F.transpose(-1, -2) \
        + G @ Qimu @ G.transpose(-1, -2)


def _rk4_substep(X, Pmm, gyro0, accel0, sg, sa, h, g, Qimu):
    """One RK4 substep of length h (B,); returns (X', Pmm', Ftot, err = 0).
    Ref src/rk4.cpp:35-103."""
    half = 0.5 * h
    h1, half1 = h[..., None], half[..., None]
    h2, half2 = h1[..., None], half1[..., None]

    K1 = X.Vsb
    F1, G1 = motion_jacobians(X, gyro0, accel0, g)
    PK1 = _stage_P(F1, G1, Pmm, Qimu)

    gy, ac = gyro0 + sg * half1, accel0 + sa * half1
    X2 = compose_motion(X, 0.5 * K1, gy, ac, half, g)
    K2 = X2.Vsb
    F2, G2 = motion_jacobians(X2, gy, ac, g)
    FK2 = F2 + F2 @ F1 * half2
    PK2 = _stage_P(F2, G2, Pmm + half2 * PK1, Qimu)

    X3 = compose_motion(X, 0.5 * K2, gy, ac, half, g)
    K3 = X3.Vsb
    F3, G3 = motion_jacobians(X3, gy, ac, g)
    FK3 = F3 + F3 @ FK2 * half2
    PK3 = _stage_P(F3, G3, Pmm + half2 * PK2, Qimu)

    gy, ac = gyro0 + sg * h1, accel0 + sa * h1
    X4 = compose_motion(X, K3, gy, ac, h, g)
    K4 = X4.Vsb
    F4, G4 = motion_jacobians(X4, gy, ac, g)
    FK4 = F4 + F4 @ FK3 * h2
    PK4 = _stage_P(F4, G4, Pmm + h2 * PK3, Qimu)

    Ktot = (K1 + 2.0 * (K2 + K3) + K4) / 6.0
    FK = (F1 + 2.0 * (FK2 + FK3) + FK4) / 6.0
    PK = (PK1 + 2.0 * (PK2 + PK3) + PK4) / 6.0

    Xn = compose_motion(X, Ktot, gy, ac, h, g)
    Ftot = torch.eye(L.MOTION, dtype=h.dtype, device=h.device) + FK * h2
    return Xn, Pmm + PK * h2, Ftot, torch.zeros_like(h)


# the Prince-Dormand tableau (src/princedormand.cpp:85-221): for each of
# stages 2-7 its time fraction and its weights on the earlier stages
_PD_STAGES = (
    (2.0 / 9.0, 2.0 / 9.0, (1,)),
    (3.0 / 9.0, 1.0 / 12.0, (1, 3)),
    (5.0 / 9.0, 1.0 / 324.0, (55, -75, 200)),
    (6.0 / 9.0, 1.0 / 330.0, (83, -195, 305, 27)),
    (1.0, 1.0 / 28.0, (-19, 63, 4, -108, 88)),
    (1.0, 1.0 / 400.0, (38, 0, 240, -243, 330, 35)),
)
_PD_OUT = (0.0862, 0.0, 0.6660, -0.7857, 0.9570, 0.0965, -0.0200)
_PD_ERR = (44.0, 0.0, -330.0, 891.0, -660.0, -45.0, 100.0)


def _combine(weights, terms):
    """sum_i w_i t_i over the nonzero weights, left to right."""
    out = None
    for w, t in zip(weights, terms):
        if w == 0:
            continue
        if out is None:
            out = w * t
        elif w < 0:
            out = out - (-w) * t
        else:
            out = out + w * t
    return out


def _pd_substep(X, Pmm, gyro0, accel0, sg, sa, h, g, Qimu):
    """One Prince-Dormand 4(5) substep (7 stages) of length h (B,):
    returns (X', Pmm', Ftot, err (B,)), err the largest entry of the
    embedded 4th/5th-order velocity difference of each sequence (the
    reference computes it but leaves it commented out,
    src/princedormand.cpp:216-220)."""
    h1 = h[..., None]
    h2 = h1[..., None]
    K = [X.Vsb]
    F1, G1 = motion_jacobians(X, gyro0, accel0, g)
    FK = [F1]
    PK = [_stage_P(F1, G1, Pmm, Qimu)]
    for frac, scale, weights in _PD_STAGES:
        step = frac * h
        step1 = step[..., None]
        gy, ac = gyro0 + sg * step1, accel0 + sa * step1
        Xs = compose_motion(X, scale * _combine(weights, K), gy, ac, step,
                            g)
        Fs, Gs = motion_jacobians(Xs, gy, ac, g)
        K.append(Xs.Vsb)
        FK.append(Fs + Fs @ (scale * _combine(weights, FK)) * h2)
        PK.append(_stage_P(Fs, Gs,
                           Pmm + (scale * _combine(weights, PK)) * h2, Qimu))

    gy, ac = gyro0 + sg * h1, accel0 + sa * h1
    Xn = compose_motion(X, _combine(_PD_OUT, K), gy, ac, h, g)
    Ftot = torch.eye(L.MOTION, dtype=h.dtype, device=h.device) \
        + _combine(_PD_OUT, FK) * h2
    diffK = 0.0002 * _combine(_PD_ERR, K)
    err = torch.amax(torch.abs(diffK), dim=-1)
    return Xn, Pmm + _combine(_PD_OUT, PK) * h2, Ftot, err


def propagate_interval(cfg: VIOConfig, X: MotionState, Pmm, Pms, gyro0,
                       accel0, sg, sa, dt):
    """The reference integrator over one interval of length dt (B,):
    Prince-Dormand or RK4 substeps of fixed h0 with the half-step trick,
    IMU inputs interpolated with slopes (sg, sa); with
    ``pd_control_stepsize`` (Prince-Dormand only) each next step is
    h scale, scale = 0.8 (tol h / err)^(1/4) clipped to [pd_min_scale,
    pd_max_scale], every step accepted, the tail split as
    src/princedormand.cpp:53-58 does. The motion/structure cross block
    Pms is multiplied by each substep's transition. Returns
    (X', Pmm', Pms')."""
    dtype, dev = Pmm.dtype, Pmm.device
    g = constant(tuple(cfg.gravity), dtype, dev)
    Qimu = imu_noise(cfg, dtype, dev)
    h0 = cfg.stepsize
    substep = _pd_substep if cfg.integration_method == "PrinceDormand" \
        else _rk4_substep
    adaptive = (cfg.pd_control_stepsize
                and cfg.integration_method == "PrinceDormand")

    def step(c):
        total, X, Pmm, Pms, gy, ac, h_next = c
        rem = dt - total
        if adaptive:
            h = torch.clamp(h_next, min=1e-6)
            h = torch.where(h > rem, rem,
                            torch.where(1.5 * h > rem, 0.5 * h, h))
        else:
            h = _fixed_step(h0, rem)
        Xn, Pmm_n, Ftot, err = substep(X, Pmm, gy, ac, sg, sa, h, g, Qimu)
        if adaptive:
            scale = torch.clamp(
                0.8 * (cfg.pd_tolerance * h / torch.clamp(err, min=1e-30))
                ** 0.25, cfg.pd_min_scale, cfg.pd_max_scale)
            h_next = h * torch.where(err <= 0.0,
                                     torch.full_like(h, cfg.pd_max_scale),
                                     scale)
        h1 = h[..., None]
        return (total + h, Xn, Pmm_n, Ftot @ Pms, gy + sg * h1,
                ac + sa * h1, h_next)

    _, X, Pmm, Pms, _, _, _ = _run_until(cfg, dt, (
        torch.zeros(dt.shape, dtype=dtype, device=dev), X, Pmm, Pms, gyro0,
        accel0, torch.full(dt.shape, h0, dtype=dtype, device=dev)), step)
    return X, Pmm, Pms


def propagate_state(cfg: VIOConfig, s: VIOState, dt) -> VIOState:
    """Full-state propagation over one measurement interval dt (B,) with
    the slopes already in the state (Estimator::Propagate,
    src/estimator.cpp:539-592): the motion block and the motion/structure
    cross block of the dense P through ``propagate_interval``, then
    Qmodel on the motion block."""
    m = L.MOTION
    X, Pmm, Pms = propagate_interval(
        cfg, s.X, s.P[:, :m, :m], s.P[:, :m, m:], s.last_gyro,
        s.last_accel, s.slope_gyro, s.slope_accel, dt)
    Pmm = Pmm + torch.diag(qmodel_diag(cfg, Pmm.dtype, Pmm.device))
    dt1 = dt[..., None]
    return s._replace(X=X, P=with_motion_block(s.P, Pmm, Pms),
                      last_gyro=s.last_gyro + s.slope_gyro * dt1,
                      last_accel=s.last_accel + s.slope_accel * dt1)


def imu_sample_update(cfg: VIOConfig, s: VIOState, gyro, accel, dt):
    """One IMU sample (B, 3) arriving dt (B,) after the previous
    measurement: refresh the interpolation slopes, then propagate
    (InertialMeasInternal -> Propagate(false), src/estimator.cpp:523-577).
    With ``clamp_signals`` each axis is clamped first
    (src/estimator.cpp:488-507). A sequence with dt <= 0 (packing padding)
    keeps its state."""
    dtype = s.P.dtype
    if cfg.clamp_signals:
        mg = constant(tuple(cfg.max_gyro), gyro.dtype, gyro.device)
        ma = constant(tuple(cfg.max_accel), accel.dtype, accel.device)
        gyro = torch.clamp(gyro, -mg, mg)
        accel = torch.clamp(accel, -ma, ma)
    safe_dt = torch.clamp(dt, min=1e-12)[..., None]
    sg = (gyro - s.last_gyro) / safe_dt
    sa = (accel - s.last_accel) / safe_dt
    new = propagate_state(cfg, s._replace(slope_gyro=sg.to(dtype),
                                          slope_accel=sa.to(dtype)), dt)
    return where_state(dt > 0, new, s)
