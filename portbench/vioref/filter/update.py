"""EKF measurement update: stacked Jacobians, MH gating, and the update
of the square-root form (port of ``xivo_tpu/filter/update.py``, batched
over a leading axis B).

The per-feature 2-row Jacobian blocks are computed for all F slots at
once and placed in a dense H of static shape (B, 2F, D); invalid slots
contribute zero rows. The (B, D, D + 3F) factor takes the factor
downdate of ``sqrt_form``. Parity targets: src/update.cpp.
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
from .sqrt_form import factor_innovation_blocks, sqrt_update
from .state import VIOState


class StackedJac(NamedTuple):
    H: torch.Tensor        # (B, 2F, D)
    inn: torch.Tensor      # (B, 2F)
    valid: torch.Tensor    # (B, F) slot validity
    pred: torch.Tensor     # (B, F, 2) predicted pixels per slot


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
                          x_s, xp_s, s.last_gyro[:, None], False)
    J_group, J_feat = jr.J_group, jr.J_feat
    okf = valid.to(dtype)
    ok3 = okf[..., None, None]
    Jm, Jc, Jg, Jf = (jr.J_motion * ok3, jr.J_cam * ok3, J_group * ok3,
                      J_feat * ok3)
    inn = jr.inn * okf[..., None]

    # without temporal / IMU calibration their columns are zero (the
    # reference omits these blocks, src/feature.cpp:593)
    colmask = [1.0] * L.MOTION
    colmask[L.TD] = 0.0
    colmask[L.BG:L.BG + 3] = [0.0] * 3
    colmask[L.CG:L.CG + 9] = [0.0] * 9
    Jm = Jm * constant(tuple(colmask), dtype, Jm.device)

    oh = (gslot[..., None] == torch.arange(G, device=gslot.device)).to(
        dtype)                                              # (B, F, G)
    Hgrp = torch.einsum("bfg,bfrk->bfrgk", oh, Jg).reshape(B, F, 2, 6 * G)
    eyeF = torch.eye(F, dtype=dtype, device=Jf.device)
    Hfeat = torch.einsum("fg,bfrk->bfrgk", eyeF, Jf).reshape(B, F, 2, 3 * F)
    H = torch.cat([Jm, Jc, Hgrp, Hfeat], dim=-1).reshape(B, 2 * F, D)
    return StackedJac(H=H, inn=inn.reshape(B, 2 * F), valid=valid,
                      pred=jr.xp_pred)



def mh_distances(P, H, inn, R):
    """Per-slot Mahalanobis distances from the 2x2 innovation blocks
    (MHGating's per-feature S = J P J^T + R I, src/update.cpp:59-70)."""
    b00, b01, b11 = factor_innovation_blocks(P, H)
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


def _rows(feat_valid):
    """Per-feature validity (B, F) -> per-row (B, 2F)."""
    return feat_valid[..., None].expand(feat_valid.shape + (2,)).reshape(
        feat_valid.shape[:-1] + (-1,))


def measurement_update(P, H, inn, diagR, feat_valid):
    """The EKF update of a factor P (the factor downdate of
    ``sqrt_form``); feat_valid is per 2-row feature block. Returns
    (err, P_new)."""
    return sqrt_update(P, H, inn, diagR, _rows(feat_valid))


def absorb_error(cfg: VIOConfig, s: VIOState, err) -> VIOState:
    """Inject the error estimate into every nominal state
    (Estimator::AbsorbError, src/estimator.cpp:875-921)."""
    d = cfg.dims
    B = err.shape[0]
    cam = s.cam

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
