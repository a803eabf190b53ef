"""Closed-form visual-inertial initialization: velocity, gravity and
feature depths from a short window (port of ``xivo_tpu/filter/vi_init.py``,
whose module docstring derives the linear system).

In the body frame at the window's start (b0), with gyro-only
preintegrated rotations R_{b0,bk} and the double integral beta_k of the
rotated specific force, p_k = v0 t_k + g t_k^2 / 2 + beta_k; feature j
sits at Rbc (lam_j u0_j) + Tbc along its first ray u0_j, and each later
observation u_kj gives three equations [u_kj]_x Rbc^T (R_{b0,bk}^T
(X_j - p_k) - Tbc) = 0, linear in x = [v0, g, lam_1..lam_F]. The ridged
normal equations are solved, then refined four times with g on the sphere
of its known norm.

Where the reference solves with ``jnp.linalg.solve`` and tests the
conditioning with ``eigvalsh``, the port solves the SPD normal equations
with ``cholesky_ex`` and ``cholesky_solve`` and tests lambda_min > t as
the success of ``cholesky_ex`` on the matrix less t I: nothing waits for
the device. One window, no batch axis; the window's tensors give the
device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..cam import models as cam_mod
from ..geom import so3
from ..ops.dense import constant
from .config import VIOConfig
from .propagate import mv


class VIInit(NamedTuple):
    v0: torch.Tensor        # (3,) velocity in the b0 frame
    g_b0: torch.Tensor      # (3,) gravity in the b0 frame
    depths: torch.Tensor    # (F,) feature depths along the first ray
    Rsb0: torch.Tensor      # (3, 3) gravity-aligned spatial <- b0
    Vsb0: torch.Tensor      # (3,) velocity in that spatial frame
    cond_ok: torch.Tensor   # () bool: the system was well conditioned
    resid: torch.Tensor     # () mean squared epipolar residual


def _pick(a, i):
    """a[i] for a 0-d index tensor i, without reading i on the host."""
    return a.index_select(0, i.reshape(1))[0]


def _preintegrate(gyro, accel, imu_dt, frame_dt):
    """Gyro-only preintegration in the b0 (frame-0 body) frame. IMU row k
    holds the samples between frames k-1 and k, frame_dt[k] the gap from
    the last of them to frame k (``runner.pack_frame_inputs``). Returns
    (R (K, 3, 3), beta (K, 3), t (K,)) at each frame time, frame 0 = (I,
    0, 0); the velocity preintegral starts at zero."""
    K = frame_dt.shape[0]
    dtype, dev = gyro.dtype, gyro.device
    R = torch.eye(3, dtype=dtype, device=dev)
    v = torch.zeros(3, dtype=dtype, device=dev)
    p = torch.zeros(3, dtype=dtype, device=dev)
    t = torch.zeros((), dtype=dtype, device=dev)

    def step(R, v, p, t, w, a, h):
        fa = mv(R @ so3.exp(w * (0.5 * h)), a)
        return (R @ so3.exp(w * h), v + fa * h, p + v * h + 0.5 * fa * h * h,
                t + h)

    Rs, betas, ts = [R], [p], [t]
    for k in range(1, K):
        for i in range(imu_dt.shape[1]):
            R, v, p, t = step(R, v, p, t, gyro[k, i], accel[k, i],
                              imu_dt[k, i])
        # the tail to the frame time holds the last valid sample
        last = torch.clamp(torch.sum((imu_dt[k] > 0).to(torch.int64)) - 1,
                           min=0)
        R, v, p, t = step(R, v, p, t, _pick(gyro[k], last),
                          _pick(accel[k], last), frame_dt[k])
        Rs.append(R), betas.append(p), ts.append(t)
    return torch.stack(Rs), torch.stack(betas), torch.stack(ts)


def _solve_spd(M, b):
    """M^-1 b for SPD M, no host sync."""
    c, _ = torch.linalg.cholesky_ex(M)
    return torch.cholesky_solve(b[:, None], c)[:, 0]


def vi_bootstrap(cfg: VIOConfig, intrin, gyro, accel, imu_dt, frame_dt,
                 meas_id, meas_xp, meas_valid, meas_depth=None,
                 g_norm: float = 9.8, ridge: float = 1e-6,
                 max_feats: int = 32) -> VIInit:
    """Closed-form init from a K-frame window of packed frame inputs:
    gyro/accel (K, KI, 3), imu_dt (K, KI), frame_dt (K,), meas_* (K, M).
    Frame 0's measurements define the reference rays, frames 1..K-1 give
    the equations; features are identified by meas_id. With meas_depth the
    depths are known and the system reduces to (v0, g)."""
    dtype, dev = gyro.dtype, gyro.device
    kind = cam_mod.MODEL_IDS[cfg.cam_model]
    Rbc = so3.exp(constant(tuple(cfg.X_Wbc), dtype, dev))
    Tbc = constant(tuple(cfg.X_Tbc), dtype, dev)
    Rcb = Rbc.T
    K = meas_id.shape[0]
    F = max_feats
    eye_f = torch.eye(F, dtype=dtype, device=dev)

    Rk, beta, tk = _preintegrate(gyro, accel, imu_dt, frame_dt)

    # up to F features seen in frame 0, the valid ones first
    fsel = torch.argsort((~meas_valid[0]).to(torch.int8), stable=True)[:F]
    fid = torch.where(meas_valid[0, fsel], meas_id[0, fsel], -1)   # (F,)

    def ray(xp):
        xc = cam_mod.unproject(kind, intrin, xp)
        return torch.cat([xc, torch.ones_like(xc[..., :1])], dim=-1)

    d0 = ray(meas_xp[0, fsel]) @ Rbc.T                     # (F, 3) in b0

    # every frame's equations at once: feature f's observation in frame k
    ids = torch.where(meas_valid, meas_id, -2)             # (K, M)
    hit = ids[:, None, :] == fid[None, :, None]            # (K, F, M)
    j = torch.argmax(hit.to(torch.int32), dim=-1)          # first hit
    ok = torch.any(hit, dim=-1) & (fid >= 0) \
        & (torch.arange(K, device=dev) > 0)[:, None]
    uk = ray(torch.gather(meas_xp, 1, j[..., None].expand(K, F, 2)))
    RcbRt = Rcb @ Rk.transpose(-1, -2)                     # (K, 3, 3)
    A_v = -RcbRt * tk[:, None, None]
    A_g = -RcbRt * (0.5 * tk * tk)[:, None, None]
    b_const = mv(Rcb, mv(Rk.transpose(-1, -2), Tbc - beta) - Tbc)
    A_lam = torch.einsum("kij,fj->kfi", RcbRt, d0)         # (K, F, 3)
    Ux = so3.hat(uk)                                       # (K, F, 3, 3)
    okf = ok.to(dtype)
    Av = (Ux @ A_v[:, None]) * okf[..., None, None]
    Ag = (Ux @ A_g[:, None]) * okf[..., None, None]
    Al = mv(Ux, A_lam) * okf[..., None]
    rhs = -mv(Ux, b_const[:, None]) * okf[..., None]
    E = K * F * 3
    if meas_depth is not None:
        # depth-aided: lam known, the unknowns reduce to (v0, g)
        rhs = rhs - Al * meas_depth[0, fsel][None, :, None]
        Alam = torch.zeros((E, F), dtype=dtype, device=dev)
    else:
        Alam = torch.einsum("kfe,fg->kfeg", Al, eye_f).reshape(E, F)
    A = torch.cat([Av.reshape(E, 3), Ag.reshape(E, 3), Alam], dim=1)
    b = rhs.reshape(E)

    N = 6 + F
    AtA = A.T @ A + ridge * torch.eye(N, dtype=dtype, device=dev)
    g_b0 = _solve_spd(AtA, A.T @ b)[3:6]

    # refinement with |g| known: over short windows the v0 t and g t^2 / 2
    # columns are nearly collinear, and the ridge trades v0 into g;
    # re-solving with g on its sphere (a 2-dof tangent parametrization,
    # iterated) restores the velocity
    Agc = A[:, 3:6]
    Arest = torch.cat([A[:, 0:3], A[:, 6:]], dim=1)         # (E, 3+F)
    e_z = constant((0.0, 0.0, 1.0), dtype, dev)
    e_x = constant((1.0, 0.0, 0.0), dtype, dev)
    for _ in range(4):
        ghat = g_b0 / torch.clamp(torch.linalg.vector_norm(g_b0), min=1e-9)
        up = torch.where(torch.abs(ghat[2]) < 0.9, e_z, e_x)
        b1 = torch.linalg.cross(ghat, up)
        b1 = b1 / torch.clamp(torch.linalg.vector_norm(b1), min=1e-9)
        Bt = torch.stack([b1, torch.linalg.cross(ghat, b1)], dim=1)  # (3,2)
        A2 = torch.cat([Arest, Agc @ Bt], dim=1)
        M2 = A2.T @ A2 + ridge * torch.eye(A2.shape[1], dtype=dtype,
                                           device=dev)
        x2 = _solve_spd(M2, A2.T @ (b - Agc @ (g_norm * ghat)))
        g_new = g_norm * ghat + Bt @ x2[-2:]
        g_b0 = g_norm * g_new / torch.clamp(
            torch.linalg.vector_norm(g_new), min=1e-9)
    v0, lam = x2[0:3], x2[3:3 + F]
    x = torch.cat([v0, g_b0, lam])
    if meas_depth is not None:
        lam = meas_depth[0, fsel]

    resid = torch.mean((A @ x - b) ** 2)
    gn = torch.linalg.vector_norm(g_b0)
    # lambda_min(AtA[:6, :6]) > 1e3 ridge <=> AtA[:6, :6] - 1e3 ridge I is
    # positive definite
    _, info = torch.linalg.cholesky_ex(
        AtA[:6, :6] - 1e3 * ridge * torch.eye(6, dtype=dtype, device=dev))
    cond_ok = (info == 0) & (gn > 0.5 * g_norm) & (gn < 1.5 * g_norm)

    # the gravity-aligned spatial frame: the least rotation taking g's
    # direction to -e_z (yaw unobservable; zero)
    ghat = g_b0 / torch.clamp(gn, min=1e-9)
    tgt = -e_z
    vcr = torch.linalg.cross(ghat, tgt)
    sn = torch.linalg.vector_norm(vcr)
    Rsb0 = so3.exp(vcr / torch.clamp(sn, min=1e-9)
                   * torch.atan2(sn, ghat @ tgt))
    return VIInit(v0=v0, g_b0=g_b0, depths=lam, Rsb0=Rsb0, Vsb0=Rsb0 @ v0,
                  cond_ok=cond_ok, resid=resid)
