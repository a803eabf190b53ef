"""EKF measurement update: stacked Jacobians, MH gating, and the update
of either covariance form (port of ``xivo_tpu/filter/update.py``, batched
over a leading axis B).

The per-feature 2-row Jacobian blocks are computed for all F slots at
once and placed in a dense H of static shape (B, 2F, D); invalid slots
contribute zero rows. A dense (B, D, D) P ("full" form) takes the
reference's Joseph-form update, a (B, D, D + 3F) factor ("sqrt" form) the
factor downdate of ``sqrt_form``; the form is read from P's last two
dims. Parity targets: src/update.cpp.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..cam import models as cam_mod
from ..geom import so3
from ..ops.dense import constant, take_rows
from . import layout as L
from .config import VIOConfig
from .features import bcast_X, compute_jacobian
from .propagate import mv
from .sqrt_form import factor_innovation_blocks, sqrt_update
from .state import VIOState


class StackedJac(NamedTuple):
    H: torch.Tensor        # (B, 2F, D)
    inn: torch.Tensor      # (B, 2F)
    valid: torch.Tensor    # (B, F) slot validity
    pred: torch.Tensor     # (B, F, 2) predicted pixels per slot


def oc_nullspace(cfg: VIOConfig, s: VIOState):
    """(B, D, 4) basis of the global-transform unobservable subspace at the
    first-estimate linearization points: columns 0-2 global translation,
    column 3 global yaw about gravity (right-multiplicative body-frame
    errors, as ``propagate.oc_correct_phi``). Motion rows at the current
    estimate, group rows at their first-estimate poses; feature,
    extrinsic, bias, intrinsic and td rows are zero (invariant)."""
    d = cfg.dims
    dtype, dev = s.P.dtype, s.P.device
    B, G = s.P.shape[0], d.n_groups
    gs = mv(s.X.Rsg, constant(tuple(cfg.gravity), dtype, dev))
    ghat = gs / (torch.linalg.vector_norm(gs, dim=-1, keepdim=True) + 1e-20)
    hg = so3.hat(ghat)                                      # (B, 3, 3)
    eye3 = torch.eye(3, dtype=dtype, device=dev)

    N = torch.zeros((B, d.full, 4), dtype=dtype, device=dev)
    N[:, L.TSB:L.TSB + 3, 0:3] = eye3
    N[:, L.WSB:L.WSB + 3, 3] = mv(s.X.Rsb.transpose(-1, -2), ghat)
    N[:, L.TSB:L.TSB + 3, 3] = mv(hg, s.X.Tsb)
    N[:, L.VSB:L.VSB + 3, 3] = mv(hg, s.X.Vsb)

    rows = torch.clamp(s.g2row, min=0)
    ok = (s.g2row >= 0).to(dtype)                           # (B, G)
    Rf = take_rows(s.groups.Rsb_fej, rows)                  # (B, G, 3, 3)
    Tf = take_rows(s.groups.Tsb_fej, rows)                  # (B, G, 3)
    Ng = torch.zeros((B, G, 6, 4), dtype=dtype, device=dev)
    Ng[:, :, 0:3, 3] = torch.einsum("bgij,bi->bgj", Rf, ghat) * ok[..., None]
    Ng[:, :, 3:6, 3] = torch.einsum("bij,bgj->bgi", hg, Tf) * ok[..., None]
    Ng[:, :, 3:6, 0:3] = eye3 * ok[..., None, None]
    N[:, L.GROUP_BEGIN:L.GROUP_BEGIN + 6 * G] = Ng.reshape(B, 6 * G, 4)
    return N


def oc_project_rows(H, N):
    """Project measurement rows H (B, m, D) onto the observable subspace:
    H <- H - (H N)(N^T N)^-1 N^T, so that H N = 0 (Hesch et al., TRO'13).
    The ridged 4 x 4 Gram is SPD: it is solved by ``cholesky_ex`` and
    ``cholesky_solve``, whose status is never read on the host. Zero rows
    stay zero."""
    HN = H @ N
    Gm = N.transpose(-1, -2) @ N
    tr = torch.diagonal(Gm, dim1=-2, dim2=-1).sum(-1)
    Gm = Gm + (1e-12 * tr)[..., None, None] * torch.eye(
        4, dtype=H.dtype, device=H.device)
    c, _ = torch.linalg.cholesky_ex(Gm)
    return H - HN @ torch.cholesky_solve(N.transpose(-1, -2), c)


def build_stacked_jacobian(cfg: VIOConfig, s: VIOState) -> StackedJac:
    """Jacobian rows for every occupied feature slot
    (Estimator::ComputeInstateJacobians, src/update.cpp:24-32)."""
    d = cfg.dims
    D = d.full
    F, G = d.n_features, d.n_groups
    B = s.P.shape[0]
    dtype = s.P.dtype
    kind = cam_mod.MODEL_IDS[cfg.cam_model]
    fr, gr = s.features, s.groups

    row = s.f2row                                       # (B, F)
    valid = row >= 0
    rowc = torch.clamp(row, min=0)
    x_s = take_rows(fr.x, rowc)
    xp_s = take_rows(fr.xp, rowc)
    gref = torch.clamp(take_rows(fr.ref, rowc), min=0)
    Rsbr_s = take_rows(gr.Rsb, gref)
    Tsbr_s = take_rows(gr.Tsb, gref)
    gslot = torch.clamp(take_rows(gr.sind, gref), min=0)

    jr = compute_jacobian(kind, s.cam[:, None], bcast_X(s.X), Rsbr_s, Tsbr_s,
                          x_s, xp_s, s.last_gyro[:, None],
                          cfg.online_camera_calib)
    J_group, J_feat = jr.J_group, jr.J_feat
    if cfg.use_fej:
        # first-estimate Jacobians: the group-pose and feature blocks are
        # linearized at the ref group's first pose estimate; the residual
        # keeps the current estimates. The feature block sits at the
        # current x unless fej_feature_block (x is ref-relative, so its
        # first estimate buys no observability, see config.py)
        xl = take_rows(fr.x_fej, rowc) if cfg.fej_feature_block else x_s
        jf = compute_jacobian(kind, s.cam[:, None], bcast_X(s.X),
                              take_rows(gr.Rsb_fej, gref),
                              take_rows(gr.Tsb_fej, gref), xl, xp_s,
                              s.last_gyro[:, None], cfg.online_camera_calib)
        J_group, J_feat = jf.J_group, jf.J_feat
    okf = valid.to(dtype)
    ok3 = okf[..., None, None]
    Jm, Jc, Jg, Jf = (jr.J_motion * ok3, jr.J_cam * ok3, J_group * ok3,
                      J_feat * ok3)
    inn = jr.inn * okf[..., None]

    # without temporal / IMU calibration their columns are zero (the
    # reference omits these blocks, src/feature.cpp:593)
    colmask = [1.0] * L.MOTION
    if not cfg.online_temporal_calib:
        colmask[L.TD] = 0.0
        colmask[L.BG:L.BG + 3] = [0.0] * 3
    if not cfg.online_imu_calib:
        colmask[L.CG:L.CG + 9] = [0.0] * 9
    if any(c == 0.0 for c in colmask):
        Jm = Jm * constant(tuple(colmask), dtype, Jm.device)

    oh = (gslot[..., None] == torch.arange(G, device=gslot.device)).to(
        dtype)                                              # (B, F, G)
    Hgrp = torch.einsum("bfg,bfrk->bfrgk", oh, Jg).reshape(B, F, 2, 6 * G)
    eyeF = torch.eye(F, dtype=dtype, device=Jf.device)
    Hfeat = torch.einsum("fg,bfrk->bfrgk", eyeF, Jf).reshape(B, F, 2, 3 * F)
    H = torch.cat([Jm, Jc, Hgrp, Hfeat], dim=-1).reshape(B, 2 * F, D)
    if cfg.use_oc_meas:
        H = oc_project_rows(H, oc_nullspace(cfg, s))
    return StackedJac(H=H, inn=inn.reshape(B, 2 * F), valid=valid,
                      pred=jr.xp_pred)


def innovation_blocks(P, H):
    """Per-feature 2x2 blocks of H P H^T, H (B, 2F, D), on either form:
    (S00, S01, S11), each (B, F)."""
    if P.shape[-1] != P.shape[-2]:
        return factor_innovation_blocks(P, H)
    HP = (H @ P).reshape(H.shape[:-2] + (-1, 2, H.shape[-1]))
    blk = HP @ H.reshape(HP.shape).transpose(-1, -2)          # (B, F, 2, 2)
    return blk[..., 0, 0], blk[..., 0, 1], blk[..., 1, 1]


def mh_distances(P, H, inn, R):
    """Per-slot Mahalanobis distances from the 2x2 innovation blocks
    (MHGating's per-feature S = J P J^T + R I, src/update.cpp:59-70)."""
    b00, b01, b11 = innovation_blocks(P, H)
    S00, S01, S11 = b00 + R, b01, b11 + R
    r0, r1 = inn[..., 0::2], inn[..., 1::2]
    det = S00 * S11 - S01 * S01
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12),
                      det)
    return (S11 * r0 * r0 - 2.0 * S01 * r0 * r1 + S00 * r1 * r1) / det


def mh_gate(cfg: VIOConfig, dist, valid):
    """Threshold-relaxation loop of MHGating (src/update.cpp:72-96),
    vectorized: the first relaxed threshold admitting min_inliers, else the
    loosest. Returns the inlier slot mask (B, F)."""
    R = cfg.mh_relax_rounds
    ks = torch.arange(R, device=dist.device)
    threshes = cfg.MH_thresh * cfg.MH_adjust_factor ** ks.to(dist.dtype)
    counts = torch.sum((dist[..., None, :] < threshes[:, None])
                       & valid[..., None, :], dim=-1)          # (B, R)
    good = counts >= cfg.min_inliers
    k = torch.argmax(good.to(torch.int32), dim=-1)   # first True
    k = torch.where(torch.any(good, dim=-1), k, torch.full_like(k, R - 1))
    thresh = cfg.MH_thresh * cfg.MH_adjust_factor ** k.to(dist.dtype)
    return valid & (dist < thresh[..., None])


def huber_robustify_R(inn, R, outlier_thresh, dtype):
    """Huber-style inflation of the measurement variance on large
    innovations (HuberOnInnovation, src/estimator.cpp:1290-1306): per 2-row
    feature block, ratio = |inn|^2 / (2 R) / outlier_thresh, and blocks
    with ratio > 1 get R scaled by sqrt(ratio). inn (B, 2F); returns the
    per-row diag(R) (B, 2F)."""
    blocks = inn.reshape(inn.shape[:-1] + (-1, 2))
    ratio = torch.sum(blocks * blocks, dim=-1) / (2.0 * R) / outlier_thresh
    scale = torch.where(ratio > 1.0, torch.sqrt(ratio),
                        torch.ones_like(ratio))
    return _rows(R * scale).to(dtype)


def joseph_rows(P, H, inn, diagR, row_valid):
    """Joseph-form EKF update of a dense P (B, D, D) with per-row validity
    row_valid (B, m) (Estimator::UpdateJosephForm, src/estimator.cpp:
    1257-1288): invalid rows get zero H/inn and unit R, so their gain
    columns are zero; S = H P H^T + R; K^T = S^-1 H P by a Cholesky solve;
    err = K inn; P <- (KH - I) P (KH - I)^T + K R K^T, symmetrized.
    A non-PD S gives NaN, as the reference's ``cho_factor`` does; its
    status is never read (that would wait for the device)."""
    dtype = P.dtype
    rv = row_valid.to(dtype)
    H = H * rv[..., :, None]
    inn = inn * rv
    diagR = torch.where(row_valid, diagR, torch.ones((), dtype=dtype,
                                                     device=P.device))
    HP = H @ P
    S = HP @ H.transpose(-1, -2) + torch.diag_embed(diagR)
    c, _ = torch.linalg.cholesky_ex(S)
    K = torch.cholesky_solve(HP, c).transpose(-1, -2)     # (B, D, m)
    err = (K @ inn[..., None])[..., 0]
    IKH = K @ H - torch.eye(P.shape[-1], dtype=dtype, device=P.device)
    P_new = IKH @ P @ IKH.transpose(-1, -2) \
        + (K * diagR[..., None, :]) @ K.transpose(-1, -2)
    return err, 0.5 * (P_new + P_new.transpose(-1, -2))


def _rows(feat_valid):
    """Per-feature validity (B, F) -> per-row (B, 2F)."""
    return feat_valid[..., None].expand(feat_valid.shape + (2,)).reshape(
        feat_valid.shape[:-1] + (-1,))


def joseph_update(P, H, inn, diagR, feat_valid):
    """Joseph-form update with per-feature (2-row) validity (B, F)."""
    return joseph_rows(P, H, inn, diagR, _rows(feat_valid))


def measurement_update(P, H, inn, diagR, feat_valid):
    """Form-dispatching EKF update: Joseph on a dense P, the factor
    downdate on a factor; feat_valid is per 2-row feature block. Returns
    (err, P_new) in the same form."""
    if P.shape[-1] == P.shape[-2]:
        return joseph_update(P, H, inn, diagR, feat_valid)
    return sqrt_update(P, H, inn, diagR, _rows(feat_valid))


def absorb_error(cfg: VIOConfig, s: VIOState, err) -> VIOState:
    """Inject the error estimate into every nominal state
    (Estimator::AbsorbError, src/estimator.cpp:875-921)."""
    d = cfg.dims
    B = err.shape[0]
    cam = s.cam + err[:, L.CAM:L.CAM + L.NCAM] \
        if cfg.online_camera_calib else s.cam

    gr = s.groups
    gerr = err[:, L.GROUP_BEGIN:L.GROUP_BEGIN + 6 * d.n_groups].reshape(
        B, d.n_groups, 6)
    instate_g = gr.sind >= 0
    gerr_row = take_rows(gerr, torch.clamp(gr.sind, 0, d.n_groups - 1)) \
        * instate_g[..., None].to(err.dtype)                # (B, NG, 6)

    # every rotation retraction (motion Wsb/Wbc/Wsg + each group row) as
    # one stacked exp / compose / project chain
    wsg = torch.cat([err[:, L.WSG:L.WSG + 2], torch.zeros_like(err[:, :1])],
                    dim=-1)
    W_all = torch.cat([err[:, None, L.WSB:L.WSB + 3],
                       err[:, None, L.WBC:L.WBC + 3], wsg[:, None],
                       gerr_row[..., :3]], dim=1)          # (B, 3+NG, 3)
    R_all = torch.cat([s.X.Rsb[:, None], s.X.Rbc[:, None], s.X.Rsg[:, None],
                       gr.Rsb], dim=1)
    Rn_all = so3.project(R_all @ so3.exp(W_all))

    X = s.X._replace(
        Rsb=Rn_all[:, 0],
        Tsb=s.X.Tsb + err[:, L.TSB:L.TSB + 3],
        Vsb=s.X.Vsb + err[:, L.VSB:L.VSB + 3],
        bg=s.X.bg + err[:, L.BG:L.BG + 3],
        ba=s.X.ba + err[:, L.BA:L.BA + 3],
        Rbc=Rn_all[:, 1],
        Tbc=s.X.Tbc + err[:, L.TBC:L.TBC + 3],
        Rsg=Rn_all[:, 2],
        td=s.X.td + err[:, L.TD],
        Cg=s.X.Cg + err[:, L.CG:L.CG + 9].reshape(B, 3, 3),
        Ca=s.X.Ca + so3.upper_tri_from6(err[:, L.CA:L.CA + 6]))

    gr = gr._replace(
        Rsb=torch.where(instate_g[..., None, None], Rn_all[:, 3:], gr.Rsb),
        Tsb=torch.where(instate_g[..., None], gr.Tsb + gerr_row[..., 3:],
                        gr.Tsb))

    ferr = err[:, d.feature_begin:].reshape(B, d.n_features, 3)
    fr = s.features
    instate_f = fr.sind >= 0
    fadd = take_rows(ferr, torch.clamp(fr.sind, 0, d.n_features - 1)) \
        * instate_f[..., None].to(err.dtype)
    fr = fr._replace(x=fr.x + fadd)
    return s._replace(X=X, cam=cam, groups=gr, features=fr)


def zero_state_entries(P, keep):
    """Zero rows and columns of P where keep (B, D) is False (gauge fixing,
    freed slots; src/estimator.cpp:753-783, 1382-1389). On a factor this is
    one-sided: zeroing row i of S zeroes row and column i of P."""
    k = keep.to(P.dtype)
    if P.shape[-1] == P.shape[-2]:
        return P * (k[..., :, None] * k[..., None, :])
    return P * k[..., :, None]
