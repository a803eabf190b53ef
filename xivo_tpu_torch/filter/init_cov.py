"""Correlated feature-initialization covariance (port of
``xivo_tpu/filter/init_cov.py``, batched over a leading axis B; its module
docstring derives the model).

A feature's local estimate x was filtered through the current pose,
extrinsics and group-pose estimates o, so to first order dx = J do + noise
with J = -(Hx^T W Hx)^-1 Hx^T W Ho over its stored observations. Admitting
features then applies the congruence P' = [[I], [J]] P [[I], [J]]^T (plus
the subfilter blocks already placed), which on the square-root factor is
a plain row transform: the new feature rows gain J S[o-rows]. On a dense
P the rows and columns gain J P[o, :] and the new-new blocks
J_i P_oo J_j^T, then P is symmetrized. The intrinsics columns of M are
zero unless ``online_camera_calib`` is on.
"""
from __future__ import annotations

import torch

from ..cam import models as cam_mod
from ..geom import so3
from ..ops.dense import adjugate3, constant, take_rows
from . import layout as L
from .config import VIOConfig
from .features import project_persp, unproject_logz
from .propagate import mv
from .state import VIOState


def obs_jacobian(kind: int, intrin, Rbc, Tbc, Rsbr, Tsbr, Rg, Tg, x):
    """Blocks of one stored observation, broadcast over leading dims:
    feature x (anchored at ref pose Rsbr/Tsbr) reprojected through the
    extrinsics Rbc/Tbc into the camera at group pose Rg/Tg. Returns
    (Hx (..., 2, 3), Hc (..., 2, 6), Hg (..., 2, 6), Hr (..., 2, 6),
    Hcam (..., 2, NCAM), good (...)), the chain of
    ``features.compute_jacobian`` with the group's pose in place of the
    body pose."""
    Rbc_t = Rbc.transpose(-1, -2)
    Xc, dXc_dx = unproject_logz(x)
    Xbr = mv(Rbc, Xc) + Tbc
    Xs = mv(Rsbr, Xbr) + Tsbr
    Rg_t = Rg.transpose(-1, -2)
    Xb = mv(Rg_t, Xs - Tg)
    Xcn = mv(Rbc_t, Xb - Tbc)
    good = Xcn[..., 2] > 1e-6
    Xcn_s = torch.where(good[..., None], Xcn,
                        constant((0.0, 0.0, 1.0), Xcn.dtype, Xcn.device))
    xcn, dxcn_dXcn = project_persp(Xcn_s)
    _, dxp_dxcn, dxp_dintrin = cam_mod.project_with_jac(kind, intrin, xcn)
    dxp_dXcn = dxp_dxcn @ dxcn_dXcn
    dXcn_dXs = Rbc_t @ Rg_t
    Hx = dxp_dXcn @ dXcn_dXs @ Rsbr @ Rbc @ dXc_dx
    # extrinsics appear on both sides of the chain: anchor -> spatial
    # (through the ref pose) and spatial -> current camera
    HWbc = dxp_dXcn @ (so3.hat(Xcn_s)
                       + dXcn_dXs @ Rsbr @ (-Rbc @ so3.hat(Xc)))
    HTbc = dxp_dXcn @ (-Rbc_t + dXcn_dXs @ Rsbr)
    HWg = dxp_dXcn @ Rbc_t @ so3.hat(Xb)                 # observing group
    HTg = dxp_dXcn @ (-dXcn_dXs)
    HWr = dxp_dXcn @ dXcn_dXs @ (-Rsbr @ so3.hat(Xbr))   # reference group
    HTr = dxp_dXcn @ dXcn_dXs
    return (Hx, torch.cat([HWbc, HTbc], -1), torch.cat([HWg, HTg], -1),
            torch.cat([HWr, HTr], -1), dxp_dintrin, good)


def _jac_blocks_fg(kind, intrin, Rbc, Tbc, Rsbr, Tsbr, Rg, Tg, x_s):
    """All (F, G) observation blocks of each sequence at once: intrin
    (B, 9), Rbc (B, 3, 3), Tbc (B, 3), Rsbr (B, F, 3, 3), Tsbr (B, F, 3),
    Rg (B, G, 3, 3), Tg (B, G, 3), x_s (B, F, 3). The same math as
    ``obs_jacobian`` with every factor that depends on f only or g only
    made once, and all seven blocks contracted against the 2 x 3 pixel
    projector in one (B, F, G, 2, 3) @ (B, F, G, 3, 21) product. Returns
    (Hx, Hc, Hg, Hr, dint, good) with leading dims (B, F, G)."""
    B, F = x_s.shape[:2]
    G = Rg.shape[1]
    Rbc_t = Rbc.transpose(-1, -2)

    Xc, dXc_dx = unproject_logz(x_s)                         # per f
    Xbr = Xc @ Rbc_t + Tbc[:, None]
    Xs = mv(Rsbr, Xbr) + Tsbr
    RsR = Rsbr @ Rbc[:, None]
    A = RsR @ dXc_dx
    E = -(RsR @ so3.hat(Xc))
    Wr = -(Rsbr @ so3.hat(Xbr))

    Bc = Rbc_t[:, None] @ Rg.transpose(-1, -2)               # per g
    Xb = torch.einsum("bgji,bfgj->bfgi", Rg,
                      Xs[:, :, None] - Tg[:, None])          # (B, F, G, 3)
    Xcn = torch.einsum("bji,bfgj->bfgi", Rbc, Xb - Tbc[:, None, None])
    good = Xcn[..., 2] > 1e-6
    Xcn_s = torch.where(good[..., None], Xcn,
                        constant((0.0, 0.0, 1.0), Xcn.dtype, Xcn.device))
    xcn, dxcn_dXcn = project_persp(Xcn_s)
    _, dxp_dxcn, dint = cam_mod.project_with_jac(kind, intrin[:, None, None],
                                                 xcn)
    P = dxp_dxcn @ dxcn_dXcn                                 # (B, F, G, 2, 3)

    Bcg = Bc[:, None]                                        # (B, 1, G, 3, 3)

    def coupled(X):                                          # Bc_g @ X_f
        return Bcg @ X[:, :, None]

    BcB = Bcg.expand(B, F, G, 3, 3)
    R_all = torch.cat([
        coupled(A),                                          # Hx
        so3.hat(Xcn_s) + coupled(E),                         # HWbc
        -Rbc_t[:, None, None] + coupled(Rsbr),               # HTbc
        Rbc_t[:, None, None] @ so3.hat(Xb),                  # HWg
        -BcB,                                                # HTg
        coupled(Wr),                                         # HWr
        BcB,                                                 # HTr
    ], dim=-1)                                               # (B,F,G,3,21)
    H_all = P @ R_all
    return (H_all[..., 0:3], H_all[..., 3:9], H_all[..., 9:15],
            H_all[..., 15:21], dint, good)


def _obs_blocks_batched(cfg: VIOConfig, s: VIOState, rows):
    """Normal-equation blocks of the given feature rows (rows (B, n)):
    (N (B, n, 3, 3), M (B, n, 3, K)) with N_f = sum Hx^T W Hx and
    M_f = sum Hx^T W Ho, K = 6 + NCAM + 6 G in the o-layout [Wbc Tbc | cam
    | group slot 0 .. G-1]. J is built at the CURRENT group poses: it
    models the correlation of the batch estimate, not the update's
    linearization."""
    d = cfg.dims
    G = d.n_groups
    dtype = s.P.dtype
    kind = cam_mod.MODEL_IDS[cfg.cam_model]
    fr, gr = s.features, s.groups
    NG = gr.gid.shape[-1]
    B, n = rows.shape

    rowc = torch.clamp(rows, min=0)
    x_s = take_rows(fr.x, rowc)
    gref_raw = take_rows(fr.ref, rowc)
    gref = torch.clamp(gref_raw, 0, NG - 1)
    ref_slot = take_rows(gr.sind, gref)
    ref_ok = (gref_raw >= 0) & (ref_slot >= 0)
    sref = torch.clamp(ref_slot, 0, G - 1)

    grow = s.g2row
    growc = torch.clamp(grow, min=0)
    seen = torch.gather(take_rows(fr.adj, rowc), 2,
                        growc[:, None, :].expand(B, n, G))
    seen = seen & (grow >= 0)[:, None] & ref_ok[..., None] \
        & (growc[:, None, :] != gref[..., None])            # (B, n, G)

    Hx, Hc, Hg, Hr, dint, cheir = _jac_blocks_fg(
        kind, s.cam, s.X.Rbc, s.X.Tbc, take_rows(gr.Rsb, gref),
        take_rows(gr.Tsb, gref), take_rows(gr.Rsb, growc),
        take_rows(gr.Tsb, growc), x_s)

    w = (seen & cheir).to(dtype)[..., None, None]
    Hxw = Hx * w
    W = 1.0 / cfg.subfilter.Rtri

    def normal(X):
        """W sum over observations g of Hx^T X: (B, n, 3, cols)."""
        return W * torch.einsum("bfgri,bfgrj->bfij", Hxw, X * w)

    N = normal(Hx)
    M_ext = normal(Hc)
    if cfg.online_camera_calib:
        M_cam = normal(dint)
    else:
        M_cam = torch.zeros((B, n, 3, L.NCAM), dtype=dtype,
                            device=s.P.device)
    # blockwise group columns: Hx^T Hg lands in the observing slot's
    # block, the reference block in the ref slot's
    M_obs = W * torch.einsum("bfgri,bfgrj->bfgij", Hxw, Hg * w)
    ohr = (sref[..., None] == torch.arange(G, device=sref.device)).to(dtype)
    M_grp = M_obs + ohr[..., None, None] * normal(Hr)[:, :, None]
    M_grp = M_grp.transpose(2, 3).reshape(B, n, 3, 6 * G)
    M = torch.cat([M_ext, M_cam, M_grp], dim=-1)

    # the anchor observation: reprojection into the ref frame is
    # pose-independent, pins (X/Z, Y/Z) and keeps N well-posed
    Xc, dXc_dx = unproject_logz(x_s)
    xcn_r, dxcn_dXc = project_persp(Xc)
    _, dxp_dxcn_r, dint_r = cam_mod.project_with_jac(kind, s.cam[:, None],
                                                     xcn_r)
    Hx_r = (dxp_dxcn_r @ dxcn_dXc @ dXc_dx) \
        * ref_ok.to(dtype)[..., None, None]
    N = N + W * torch.einsum("bfri,bfrj->bfij", Hx_r, Hx_r)
    if cfg.online_camera_calib:
        # the anchor observation couples to the intrinsics alone
        M_cam_r = W * torch.einsum("bfri,bfrj->bfij", Hx_r, dint_r)
        M = torch.cat([M[..., :6], M[..., 6:6 + L.NCAM] + M_cam_r,
                       M[..., 6 + L.NCAM:]], dim=-1)
    return N, M


def _init_jacobians(cfg: VIOConfig, s: VIOState, rows, valid):
    """J (B, n, 3, K) for the given feature rows, zero where invalid or
    where N is near-singular (lambda_min(N) > 1e-4 tr(N)/3 tested by
    Sylvester's criterion on N - thr I; inverse by the adjugate)."""
    dtype = s.P.dtype
    N, M = _obs_blocks_batched(cfg, s, rows)
    tr = (N[..., 0, 0] + N[..., 1, 1] + N[..., 2, 2]) / 3.0
    eye3 = torch.eye(3, dtype=dtype, device=N.device)
    Mm = N - (1e-4 * tr)[..., None, None] * eye3
    det2 = Mm[..., 0, 0] * Mm[..., 1, 1] - Mm[..., 0, 1] * Mm[..., 1, 0]
    det3 = (Mm[..., 0, 0] * (Mm[..., 1, 1] * Mm[..., 2, 2]
                             - Mm[..., 1, 2] * Mm[..., 2, 1])
            - Mm[..., 0, 1] * (Mm[..., 1, 0] * Mm[..., 2, 2]
                               - Mm[..., 1, 2] * Mm[..., 2, 0])
            + Mm[..., 0, 2] * (Mm[..., 1, 0] * Mm[..., 2, 1]
                               - Mm[..., 1, 1] * Mm[..., 2, 0]))
    use = valid & (Mm[..., 0, 0] > 0) & (det2 > 0) & (det3 > 0)
    co, det = adjugate3(N + (1e-6 * tr + 1e-12)[..., None, None] * eye3)
    Ainv = co / torch.where(torch.abs(det) < 1e-30, 1e-30, det)[..., None,
                                                                  None]
    J = -(Ainv @ M)
    return torch.where(use[..., None, None], J, 0.0)


def _o_indices(G: int):
    """The o-rows of the state: Wbc, Tbc, the intrinsics, the group slots."""
    return (tuple(range(L.WBC, L.WBC + 6)) + tuple(range(L.CAM,
                                                         L.CAM + L.NCAM))
            + tuple(range(L.GROUP_BEGIN, L.GROUP_BEGIN + 6 * G)))


def add_init_correlations(cfg: VIOConfig, s: VIOState, new_slot_mask,
                          row_of_slot) -> VIOState:
    """Augment P with the exact first-order correlations of the slots
    admitted this frame (new_slot_mask, row_of_slot (B, F)).

    With ``cfg.init_corr_chunk`` = A in (0, F) the cohort is compacted
    and processed A slots at a time. The reference loops over the
    data-dependent number of chunks ceil(count / A); here all ceil(F / A)
    chunks run, and a chunk past a sequence's count has no valid slot: its
    J is exactly zero, so it adds exactly zero to a factor, and a dense P
    keeps its value there (the chunk's symmetrization is skipped). The same
    result with no host sync. Chunking is exact: on a factor a chunk writes
    only feature rows, which neither J nor the o-rows read; on a dense P
    each chunk re-reads the o-rows, whose feature columns then hold the
    earlier chunks' cross terms. A sequence with no new slot keeps a dense
    P as it was (the reference skips the pass under a cond)."""
    d = cfg.dims
    F, G = d.n_features, d.n_groups
    dtype = s.P.dtype
    B = s.P.shape[0]
    dense = s.P.shape[-1] == s.P.shape[-2]
    oidx = constant(_o_indices(G), torch.int64, s.P.device)
    use0 = new_slot_mask & (row_of_slot >= 0)
    A = int(cfg.init_corr_chunk)
    if A <= 0 or A >= F:
        Jf = _init_jacobians(cfg, s, row_of_slot, use0)      # (B, F, 3, K)
        C, X = _congruence_terms(s.P, Jf, oidx)
        P = _apply_congruence(cfg, s.P, C, X)
        if dense:
            P = torch.where(torch.any(new_slot_mask, -1)[:, None, None], P,
                            s.P)
        return s._replace(P=P)

    ar = torch.arange(F, device=s.P.device)
    order = torch.cumsum(use0.to(torch.int64), -1) - 1
    count = torch.sum(use0.to(torch.int64), -1, keepdim=True)
    ohc = (order[:, None, :] == ar[:, None]) & use0[:, None, :]
    comp_slots = torch.argmax(ohc.to(torch.int32), dim=-1)   # (B, F)
    P = s.P
    for c in range(-(-F // A)):
        pos = c * A + torch.arange(A, device=s.P.device)
        slot = torch.where(pos < count,
                           comp_slots[:, torch.clamp(pos, max=F - 1)], -1)
        slotc = torch.clamp(slot, 0, F - 1)
        rows = take_rows(row_of_slot, slotc)                 # (B, A)
        valid = (slot >= 0) & (rows >= 0)
        Jf = _init_jacobians(cfg, s, rows, valid)            # (B, A, 3, K)
        C, X = _congruence_terms(P, Jf, oidx)
        ohp = ((slotc[:, None, :] == ar[:, None]) & valid[:, None, :]).to(
            dtype)                                           # (B, F, A)
        Cf = torch.einsum("bfa,baid->bfid", ohp, C)
        if dense:
            X = torch.einsum("bfa,baicj->bficj", ohp, X)
            X = torch.einsum("bgc,bficj->bfigj", ohp, X)
            P = torch.where((c * A < count)[:, :, None],
                            _apply_congruence(cfg, P, Cf, X), P)
        else:
            P = _apply_congruence(cfg, P, Cf, None)
    return s._replace(P=P)


def _congruence_terms(P, Jf, oidx):
    """For Jf (B, n, 3, K): the cross rows C = J P[o, :] (B, n, 3, Dc)
    and, on a dense P, the pairwise blocks J_i P_oo J_j^T
    (B, n, 3, n, 3), else None."""
    P_o = P[:, oidx]                                         # (B, K, Dc)
    C = Jf @ P_o[:, None]
    if P.shape[-1] != P.shape[-2]:
        return C, None
    Q = Jf @ P_o[:, None, :, oidx]
    return C, torch.einsum("bfil,bgjl->bfigj", Q, Jf)


def _apply_congruence(cfg: VIOConfig, P, C, X):
    """The congruence from its terms for all F slots (C (B, F, 3, Dc), X
    (B, F, 3, F, 3)): on a factor the new feature rows gain C; on a dense
    P the feature rows gain C, the feature columns C^T and the feature
    block X, and P is symmetrized."""
    fb = cfg.dims.feature_begin
    B = P.shape[0]
    C = C.reshape(B, 3 * cfg.dims.n_features, -1)
    if P.shape[-1] != P.shape[-2]:
        return torch.cat([P[:, :fb], P[:, fb:] + C], dim=1)
    P = P.clone()
    P[:, fb:, :] += C
    P[:, :, fb:] += C.transpose(-1, -2)
    P[:, fb:, fb:] += X.reshape(B, C.shape[1], C.shape[1])
    return 0.5 * (P + P.transpose(-1, -2))
