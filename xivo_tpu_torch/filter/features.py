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

import math

import torch

from ..cam import models as cam_mod
from ..geom import so3
from ..ops.dense import constant
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


def predict_pixel(cam_kind: int, intrin, X, Rsbr, Tsbr, x):
    """Reproject a feature into the current frame (Feature::Predict)."""
    Xc, _ = unproject_logz(x)
    Xs = mv(Rsbr, mv(X.Rbc, Xc) + X.Tbc) + Tsbr
    Xb = mv(X.Rsb.transpose(-1, -2), Xs - X.Tsb)
    Xcn = mv(X.Rbc.transpose(-1, -2), Xb - X.Tbc)
    xcn, _ = project_persp(Xcn)
    return cam_mod.project(cam_kind, intrin, xcn), Xcn[..., 2]


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


def _dot(a, b):
    return (a * b).sum(-1)


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1)


def _ray(xc):
    return torch.cat([xc, torch.ones_like(xc[..., :1])], dim=-1)


def triangulate_two_view(g12_R, g12_T, xc1, xc2, method: str = "dlt_avg"):
    """Two-view triangulation of Xc1 (src/helpers.cpp); g12 maps camera-2
    coordinates to camera-1 coordinates, xc1/xc2 are unit-plane rays."""
    if method in ("direct_linear_transform_avg", "dlt_avg"):
        d1 = _ray(xc1)
        d2g = mv(g12_R, _ray(xc2))
        o2 = g12_T
        a, b, c = _dot(d1, d1), _dot(d1, d2g), _dot(d2g, d2g)
        d, e = _dot(d1, o2), _dot(d2g, o2)
        den = a * c - b * b
        den = torch.where(torch.abs(den) < 1e-12,
                          torch.full_like(den, 1e-12), den)
        t1 = (c * d - b * e) / den
        t2 = (b * d - a * e) / den
        return 0.5 * (t1[..., None] * d1 + (o2 + t2[..., None] * d2g))
    if method in ("direct_linear_transform_svd", "dlt_svd"):
        R21 = g12_R.transpose(-1, -2)
        T21 = -mv(R21, g12_T)
        kw = dict(dtype=xc1.dtype, device=xc1.device)
        P1 = torch.cat([torch.eye(3, **kw), torch.zeros((3, 1), **kw)], -1)
        P2 = torch.cat([R21, T21[..., None]], dim=-1)
        A = torch.stack([
            xc1[..., 0:1] * P1[2] - P1[0],
            xc1[..., 1:2] * P1[2] - P1[1],
            xc2[..., 0:1] * P2[..., 2, :] - P2[..., 0, :],
            xc2[..., 1:2] * P2[..., 2, :] - P2[..., 1, :]], dim=-2)
        _, _, vt = torch.linalg.svd(A)
        Xh = vt[..., -1, :]
        w = Xh[..., 3]
        w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
        return Xh[..., :3] / w[..., None]
    X, _ = _triangulate_angular(g12_R, g12_T, xc1, xc2, method,
                                max_theta_thresh=math.pi, beta_thresh=0.0)
    return X


def _triangulate_angular(g12_R, g12_T, xc1, xc2, method, max_theta_thresh,
                         beta_thresh):
    """Optimal angular two-view triangulation (Lee & Civera, ICCV'17;
    L1Angular / L2Angular / LinfAngular, src/helpers.cpp:156-371) with the
    cheirality / angular-reprojection / parallax checks. Returns (Xc1, ok)."""
    eps = 1e-20
    R10 = g12_R.transpose(-1, -2)
    t10 = -mv(R10, g12_T)
    f0 = _ray(xc1)
    f0 = f0 / (_norm(f0)[..., None] + eps)
    f1 = _ray(xc2)
    f1 = f1 / (_norm(f1)[..., None] + eps)
    m0 = mv(R10, f0)
    m1 = f1
    t10 = t10.expand(m0.shape)

    def _unit(v):
        return v / (_norm(v)[..., None] + eps)

    def cross(a, b):
        return torch.linalg.cross(a, b, dim=-1)

    def proj_out(v, n):
        return v - _dot(v, n)[..., None] * n

    if method == "l1_angular":
        a0 = _norm(cross(_unit(m0), t10))
        a1 = _norm(cross(_unit(m1), t10))
        n0 = _unit(cross(m0, t10))
        n1 = _unit(cross(m1, t10))
        fix0 = (a0 <= a1)[..., None]
        m0p = torch.where(fix0, proj_out(m0, n1), m0)
        m1p = torch.where(fix0, m1, proj_out(m1, n0))
    elif method == "l2_angular":
        t10_hat = _unit(t10)
        kw = dict(dtype=t10.dtype, device=t10.device)
        seed = torch.where((torch.abs(t10_hat[..., 0]) < 0.9)[..., None],
                           constant((1.0, 0.0, 0.0), **kw),
                           constant((0.0, 1.0, 0.0), **kw))
        e1 = _unit(cross(t10_hat, seed))
        e2 = cross(t10_hat, e1)
        A = torch.stack([_unit(m0), _unit(m1)], dim=-2)       # (..., 2, 3)
        C = A @ torch.stack([e1, e2], dim=-1)                 # (..., 2, 2)
        M = C.transpose(-1, -2) @ C
        a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 1, 1]
        lam_min = 0.5 * (a + c) - torch.sqrt(0.25 * (a - c) ** 2 + b * b)
        v_a = torch.stack([b, lam_min - a], dim=-1)
        v_b = torch.stack([lam_min - c, b], dim=-1)
        w = torch.where((_norm(v_a) >= _norm(v_b))[..., None], v_a, v_b)
        w = torch.where((_norm(w) < eps)[..., None],
                        torch.where((a <= c)[..., None],
                                    constant((1.0, 0.0), **kw),
                                    constant((0.0, 1.0), **kw)), w)
        w = w / (_norm(w)[..., None] + eps)
        n_hat = w[..., 0:1] * e1 + w[..., 1:2] * e2
        m0p = proj_out(m0, n_hat)
        m1p = proj_out(m1, n_hat)
    elif method == "linf_angular":
        na = cross(_unit(m0) + _unit(m1), t10)
        nb = cross(_unit(m0) - _unit(m1), t10)
        n_hat = _unit(torch.where((_norm(na) >= _norm(nb))[..., None],
                                  na, nb))
        m0p = proj_out(m0, n_hat)
        m1p = proj_out(m1, n_hat)
    else:
        raise ValueError(f"unknown triangulation method {method!r}")

    z = cross(m1p, m0p)
    zn2 = _dot(z, z) + eps
    X1 = (_dot(z, cross(t10, m0p)) / zn2)[..., None] * m1p
    X = mv(g12_R, X1) + g12_T

    lam0 = _dot(z, cross(t10, m1p)) / zn2
    lam1 = _dot(z, cross(t10, m0p)) / zn2
    cheirality = (lam0 > 0) & (lam1 > 0)

    def _angle(u, v):
        c = _dot(u, v) / ((_norm(u) + eps) * (_norm(v) + eps))
        return torch.arccos(torch.clamp(c, -1.0, 1.0))

    max_theta = torch.maximum(_angle(m0, m0p), _angle(m1, m1p))
    beta = _angle(m0p, m1p)
    ok = cheirality & (max_theta <= max_theta_thresh) & (beta >= beta_thresh)
    return X, ok


def triangulate_two_view_checked(g12_R, g12_T, xc1, xc2, method,
                                 max_theta_thresh, beta_thresh):
    """Triangulate and report validity (the DLT methods have no checks in
    the reference, so ok is True there)."""
    if method in ("l1_angular", "l2_angular", "linf_angular"):
        return _triangulate_angular(g12_R, g12_T, xc1, xc2, method,
                                    max_theta_thresh, beta_thresh)
    X = triangulate_two_view(g12_R, g12_T, xc1, xc2, method)
    return X, torch.ones(X.shape[:-1], dtype=torch.bool, device=X.device)


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
