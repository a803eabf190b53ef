"""Per-feature geometry (port of ``xivo_tpu/filter/features.py``).

The reference writes each function for ONE feature and ``vmap``s it over
the track table; here every function broadcasts over leading dimensions
(typically (B, N)). Motion-state fields must broadcast against the
per-feature tensors: callers pass ``X`` through :func:`bcast_X`.

Local parametrization (log-depth): x = (X/Z, Y/Z, log Z) in the
REFERENCE group's camera frame (src/feature.h:258-262).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..cam import models as cam_mod
from ..geom import so3
from .propagate import mv


def bcast_X(X, n_lead: int = 1):
    """Insert n_lead singleton axes after the batch axis of every
    MotionState field, so (B, ...) fields broadcast against (B, N, ...)."""
    return type(X)(*(f.reshape(f.shape[:1] + (1,) * n_lead + f.shape[1:])
                     for f in X))


def _stack_rows(rows):
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def unproject_logz(x):
    """(X/Z, Y/Z, log Z) -> Xc, with 3x3 Jacobian."""
    z = torch.exp(x[..., 2])
    zero = torch.zeros_like(z)
    Xc = torch.stack([x[..., 0] * z, x[..., 1] * z, z], dim=-1)
    J = _stack_rows([[z, zero, x[..., 0] * z],
                     [zero, z, x[..., 1] * z],
                     [zero, zero, z]])
    return Xc, J


def project_logz(Xc):
    """Xc -> (X/Z, Y/Z, log Z), with 3x3 Jacobian."""
    iz = 1.0 / Xc[..., 2]
    zero = torch.zeros_like(iz)
    x = torch.stack([Xc[..., 0] * iz, Xc[..., 1] * iz, torch.log(Xc[..., 2])],
                    dim=-1)
    J = _stack_rows([[iz, zero, -Xc[..., 0] * iz * iz],
                     [zero, iz, -Xc[..., 1] * iz * iz],
                     [zero, zero, iz]])
    return x, J


def project_persp(Xc):
    """Xc -> (X/Z, Y/Z) with 2x3 Jacobian."""
    iz = 1.0 / Xc[..., 2]
    zero = torch.zeros_like(iz)
    xc = Xc[..., :2] * iz[..., None]
    J = _stack_rows([[iz, zero, -Xc[..., 0] * iz * iz],
                     [zero, iz, -Xc[..., 1] * iz * iz]])
    return xc, J


class JacRow(NamedTuple):
    """A feature's 2-row measurement Jacobian, split by block."""
    J_motion: torch.Tensor  # (..., 2, MOTION)
    J_cam: torch.Tensor     # (..., 2, NCAM)
    J_group: torch.Tensor   # (..., 2, 6) w.r.t. reference-group pose
    J_feat: torch.Tensor    # (..., 2, 3) w.r.t. local feature state
    inn: torch.Tensor       # (..., 2) innovation (measured - predicted)
    xp_pred: torch.Tensor   # (..., 2) predicted pixel


def compute_jacobian(cam_kind: int, intrin, X, Rsbr, Tsbr, x, xp_meas,
                     gyro, online_camera_calib: bool):
    """Closed-form measurement Jacobian chain (Feature::ComputeJacobian,
    src/feature.cpp:542-656), including the td / Cg / bg blocks. X, intrin
    and gyro must broadcast against the per-feature inputs."""
    Rsb, Tsb, Rbc, Tbc = X.Rsb, X.Tsb, X.Rbc, X.Tbc
    Rsb_t, Rbc_t = Rsb.transpose(-1, -2), Rbc.transpose(-1, -2)

    Xc, dXc_dx = unproject_logz(x)
    Xbr = mv(Rbc, Xc) + Tbc
    Xs = mv(Rsbr, Xbr) + Tsbr
    Xb = mv(Rsb_t, Xs - Tsb)
    Xcn = mv(Rbc_t, Xb - Tbc)

    dXbr_dWbc = -Rbc @ so3.hat(Xc)
    dXs_dXbr = Rsbr
    dXs_dWsbr = -Rsbr @ so3.hat(Xbr)
    dXcn_dXb = Rbc_t

    dXcn_dXs = dXcn_dXb @ Rsb_t
    dXcn_dTbc = -Rbc_t + dXcn_dXs @ dXs_dXbr
    dXcn_dWbc = so3.hat(Xcn) + dXcn_dXs @ dXs_dXbr @ dXbr_dWbc
    dXcn_dTsb = dXcn_dXb @ (-Rsb_t)
    dXcn_dWsb = dXcn_dXb @ so3.hat(Xb)
    dXcn_dTsbr = dXcn_dXs
    dXcn_dWsbr = dXcn_dXs @ dXs_dWsbr
    dXcn_dx = dXcn_dXs @ dXs_dXbr @ Rbc @ dXc_dx

    # temporal-calibration blocks (src/feature.cpp:593-609)
    gyro_calib = mv(X.Cg, gyro) - X.bg
    dXcn_dtd = -mv(Rbc_t, mv(so3.hat(gyro_calib) @ Rsb_t, Xs - Tsb)
                   + mv(Rsb_t, X.Vsb))
    dXcn_dW = Rbc_t @ so3.hat(mv(Rsb_t, Xs - Tsb)) * X.td[..., None, None]
    dW_dCg = (torch.eye(3, dtype=x.dtype, device=x.device)[:, :, None]
              * gyro[..., None, None, :]).reshape(gyro.shape[:-1] + (3, 9))
    dXcn_dCg = dXcn_dW @ dW_dCg
    dXcn_dbg = -dXcn_dW

    xcn, dxcn_dXcn = project_persp(Xcn)
    xp_pred, dxp_dxcn, dxp_dintrin = cam_mod.project_with_jac(
        cam_kind, intrin, xcn)
    dxp_dXcn = dxp_dxcn @ dxcn_dXcn

    lead = xcn.shape[:-1]

    def Z(c):
        return torch.zeros(lead + (2, c), dtype=x.dtype, device=x.device)

    Jm = torch.cat([
        dxp_dXcn @ dXcn_dWsb, dxp_dXcn @ dXcn_dTsb, Z(3),    # Wsb Tsb Vsb
        dxp_dXcn @ dXcn_dbg, Z(3),                          # bg ba
        dxp_dXcn @ dXcn_dWbc, dxp_dXcn @ dXcn_dTbc,         # Wbc Tbc
        Z(2),                                               # Wsg
        mv(dxp_dXcn, dXcn_dtd)[..., None],                  # td
        dxp_dXcn @ dXcn_dCg,                                # Cg
        Z(6)], dim=-1)                                      # Ca

    J_cam = dxp_dintrin if online_camera_calib \
        else torch.zeros_like(dxp_dintrin)
    J_group = torch.cat([dxp_dXcn @ dXcn_dWsbr, dxp_dXcn @ dXcn_dTsbr],
                        dim=-1)
    J_feat = dxp_dXcn @ dXcn_dx
    return JacRow(J_motion=Jm, J_cam=J_cam, J_group=J_group, J_feat=J_feat,
                  inn=xp_meas - xp_pred, xp_pred=xp_pred)


def _inv2(S):
    """Closed-form 2x2 inverse (adjugate / determinant)."""
    det = S[..., 0, 0] * S[..., 1, 1] - S[..., 0, 1] * S[..., 1, 0]
    adj = _stack_rows([[S[..., 1, 1], -S[..., 0, 1]],
                       [-S[..., 1, 0], S[..., 0, 0]]])
    return adj / det[..., None, None]


def subfilter_update(cam_kind: int, intrin, X, Rsbr, Tsbr, x, Psub, xp_meas,
                     Rtri: float, MH_thresh: float):
    """One feature's 3-dim depth subfilter EKF step
    (Feature::SubfilterUpdate, src/feature.cpp:246-297): predicted
    reprojection, MH-ratio R inflation, Joseph-form update. Leading
    dimensions broadcast, so the same function steps the whole table
    (``subfilter_update_table``). Returns (x', Psub', outlier_inc, bad)."""
    Xc, dXc_dx = unproject_logz(x)
    Rcs = (X.Rsb @ X.Rbc).transpose(-1, -2)
    Tcs = -mv(Rcs, mv(X.Rsb, X.Tbc) + X.Tsb)
    Rtot = Rcs @ (Rsbr @ X.Rbc)
    Ttot = mv(Rcs, mv(Rsbr, X.Tbc) + Tsbr) + Tcs
    Xcn = mv(Rtot, Xc) + Ttot
    xcn, dxcn_dXcn = project_persp(Xcn)
    xp_pred, dxp_dxcn, _ = cam_mod.project_with_jac(cam_kind, intrin, xcn)

    H = dxp_dxcn @ dxcn_dXcn @ Rtot @ dXc_dx                 # (..., 2, 3)
    inn = xp_meas - xp_pred
    eye2 = torch.eye(2, dtype=x.dtype, device=x.device)
    PHt = Psub @ H.transpose(-1, -2)                         # (..., 3, 2)
    S = H @ PHt + Rtri * eye2
    ratio = (inn * mv(_inv2(S), inn)).sum(-1) / MH_thresh
    bad = ratio > 1.0
    infl = torch.where(bad, Rtri * (ratio - 1.0), torch.zeros_like(ratio))
    S = S + infl[..., None, None] * eye2
    outlier_inc = torch.where(bad, torch.sqrt(torch.clamp(ratio, min=0.0)),
                              torch.zeros_like(ratio))
    K = PHt @ _inv2(S)                                       # (..., 3, 2)
    x_new = x + mv(K, inn)
    I_KH = torch.eye(3, dtype=x.dtype, device=x.device) - K @ H
    P_new = I_KH @ Psub @ I_KH.transpose(-1, -2) \
        + Rtri * (K @ K.transpose(-1, -2))
    return x_new, P_new, outlier_inc, bad


# the reference's table form is the plane-algebra rewrite of the same step
# for the TPU; here it is the same function over (B, N) leading dimensions
subfilter_update_table = subfilter_update


def change_owner(X, Rsbr_old, Tsbr_old, Rsbr_new, Tsbr_new, x, Psub):
    """Re-parametrize features to a new reference group
    (Feature::ChangeOwner, src/feature.cpp:211-243). Returns (x', Psub',
    ok) with ok False on negative depth."""
    Xc, dXc_dx = unproject_logz(x)
    Rsc_old = Rsbr_old @ X.Rbc
    Xs = mv(Rsc_old, Xc) + mv(Rsbr_old, X.Tbc) + Tsbr_old
    dXs_dx = Rsc_old @ dXc_dx
    Rsc_new_t = (Rsbr_new @ X.Rbc).transpose(-1, -2)
    Xcn = mv(Rsc_new_t, Xs - (mv(Rsbr_new, X.Tbc) + Tsbr_new))
    dXcn_dx = Rsc_new_t @ dXs_dx
    ok = Xcn[..., 2] > 0
    zsafe = torch.where(ok, Xcn[..., 2], torch.ones_like(Xcn[..., 2]))
    Xcn_safe = torch.cat([Xcn[..., :2], zsafe[..., None]], dim=-1)
    xn, dxn_dXcn = project_logz(Xcn_safe)
    J = dxn_dXcn @ dXcn_dx
    return xn, J @ Psub @ J.transpose(-1, -2), ok
