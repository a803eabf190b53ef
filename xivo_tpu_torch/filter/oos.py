"""Out-of-state (MSCKF-style) measurement update (port of
``xivo_tpu/filter/oos.py``, batched over a leading axis B).

Features that leave the tracker without ever entering the state spend
their multi-view geometry in one joint update: each candidate's (2G, D)
Jacobian over the instate group slots is projected onto the left
nullspace of its landmark Jacobian by three closed-form Householder
reflectors (the reference's sweep and sign rule, so that the rows match
it, not a QR), and every surviving row joins one update with
R = oos_meas_std^2: a factor downdate on the square-root form, a Joseph
update on the dense form. A stack taller than
``compression_trigger_ratio`` x D is first compressed, in either form, by
one masked Cholesky (kernel B1 at (D + 1)^2) of its bordered Gram.
With ``use_oc_meas`` the rows are first projected onto the observable
subspace, as the instate rows are (``update.oc_project_rows``).
"""
from __future__ import annotations

import torch

from ..cam import models as cam_mod
from ..geom import so3
from ..ops import lanes_chol
from ..ops.dense import constant, take_rows
from . import layout as L
from .config import VIOConfig
from .features import project_persp, unproject_logz
from .propagate import mv
from .sqrt_form import sqrt_update
from .state import VIOState, where_state
from .update import (absorb_error, joseph_rows, oc_nullspace,
                     oc_project_rows)


def _householder_nullspace(Hf, Hx, inn):
    """Left-nullspace projection of the (..., m, 3) landmark Jacobian by a
    fixed sweep of three Householder reflectors applied to [Hx | inn];
    rows 3: of the result are kept. Equal to the complete-QR projection up
    to a left orthogonal transform (the same EKF update under iid noise);
    masked (zero) rows of Hf stay zero. Returns (Ho (..., m-3, D),
    inn_o (..., m-3))."""
    m = Hf.shape[-2]
    dtype = Hf.dtype
    ridx = torch.arange(m, device=Hf.device)
    M = torch.cat([Hx, inn[..., None]], dim=-1)
    A = Hf
    for k in range(3):
        x = torch.where(ridx >= k, A[..., :, k], 0.0)
        nx = torch.sqrt(torch.sum(x * x, dim=-1))
        sign = torch.where(x[..., k] >= 0, 1.0, -1.0).to(dtype)
        v = x + (sign * nx)[..., None] * (ridx == k).to(dtype)
        vn2 = torch.sum(v * v, dim=-1)
        ok = vn2 > 1e-24
        beta = torch.where(ok, 2.0 / torch.where(ok, vn2, 1.0), 0.0)
        bv = (beta[..., None] * v)[..., :, None]
        A = A - bv * (v[..., None, :] @ A)
        M = M - bv * (v[..., None, :] @ M)
    return M[..., 3:, :-1], M[..., 3:, -1]


def _oos_rows_all(cfg: VIOConfig, s: VIOState, rows):
    """OOS rows for all CAP candidate rows at once (rows (B, CAP), -1 for
    none): (Ho (B, CAP, 2G, D), inn (B, CAP, 2G), valid (B, CAP, 2G)). The
    per-(candidate, slot) blocks are built in one pass; rows of unseen or
    behind-camera slots are zero."""
    fej = cfg.use_fej and cfg.oos_fej
    d = cfg.dims
    G, D = d.n_groups, d.full
    NG = s.groups.gid.shape[-1]
    dtype = s.P.dtype
    kind = cam_mod.MODEL_IDS[cfg.cam_model]
    fr, gr = s.features, s.groups
    B, CAP = rows.shape

    rowc = torch.clamp(rows, min=0)
    gref = torch.clamp(take_rows(fr.ref, rowc), 0, NG - 1)
    Rbc, Tbc = s.X.Rbc, s.X.Tbc
    Rbc_t = Rbc.transpose(-1, -2)
    Xc, _ = unproject_logz(take_rows(fr.x, rowc))           # (B, CAP, 3)
    Xbr = (Xc @ Rbc_t + Tbc[:, None])                       # Rbc Xc + Tbc

    def anchored(Rs, Ts):       # the landmark in space via the ref pose
        return mv(take_rows(Rs, gref), Xbr) + take_rows(Ts, gref)

    Xs = anchored(gr.Rsb, gr.Tsb)
    Xs_l = anchored(gr.Rsb_fej, gr.Tsb_fej) if fej else Xs

    grow = s.g2row                                          # (B, G)
    ok_g = grow >= 0
    growc = torch.clamp(grow, min=0)
    seen = torch.gather(take_rows(fr.adj, rowc), 2,
                        growc[:, None, :].expand(B, CAP, G)) & ok_g[:, None]
    xp_obs = torch.gather(take_rows(fr.adj_xp, rowc), 2,
                          growc[:, None, :, None].expand(B, CAP, G, 2))
    zhat = constant((0.0, 0.0, 1.0), dtype, s.P.device)
    intrin = s.cam[:, None, None]

    def chain(Rs, Ts, Xs_f):
        """Each slot's pose and the landmark in its body and camera
        frames: (Rg, Xb, Xcn)."""
        Rg, Tg = take_rows(Rs, growc), take_rows(Ts, growc)  # (B, G, ...)
        Xb = torch.einsum("bgji,bfgj->bfgi", Rg,
                          Xs_f[:, :, None] - Tg[:, None])   # (B, CAP, G, 3)
        Xcn = torch.einsum("bji,bfgj->bfgi", Rbc, Xb - Tbc[:, None, None])
        return Rg, Xb, Xcn

    Rg, Xb, Xcn = chain(gr.Rsb, gr.Tsb, Xs)
    good = seen & (Xcn[..., 2] > 1e-6)
    Xcn_s = torch.where(good[..., None], Xcn, zhat)
    xcn, dxcn_dXcn = project_persp(Xcn_s)
    xp_pred, dxp_dxcn, _ = cam_mod.project_with_jac(kind, intrin, xcn)
    inn = xp_obs - xp_pred

    if fej:
        # the Jacobian chain at the groups' first pose estimates
        Rg_l, Xb_l, Xcn_l = chain(gr.Rsb_fej, gr.Tsb_fej, Xs_l)
        good = good & (Xcn_l[..., 2] > 1e-6)
        Xcn_l = torch.where(good[..., None], Xcn_l, zhat)
        xcn_l, dxcn_l = project_persp(Xcn_l)
        _, dxp_l, _ = cam_mod.project_with_jac(kind, intrin, xcn_l)
        P2 = dxp_l @ dxcn_l                                  # (B,CAP,G,2,3)
    else:
        Rg_l, Xb_l, Xcn_l = Rg, Xb, Xcn_s
        P2 = dxp_dxcn @ dxcn_dXcn

    Bc = Rbc_t[:, None] @ Rg_l.transpose(-1, -2)            # Rbc^T Rg^T
    Hf = P2 @ Bc[:, None]                                   # w.r.t. Xs
    HW = P2 @ Rbc_t[:, None, None] @ so3.hat(Xb_l)          # group W
    HT = -Hf                                                # group T
    HWbc = P2 @ so3.hat(Xcn_l)
    HTbc = P2 @ (-Rbc_t)[:, None, None]

    w = good.to(dtype)[..., None, None]
    eye = torch.eye(G, dtype=dtype, device=s.P.device)
    # the group pair lands at slot-column block g, Wbc/Tbc at their
    # offsets, everything else zero
    Hgrp = torch.einsum("gh,bfgrk->bfgrhk", eye,
                        torch.cat([HW, HT], dim=-1) * w).reshape(
                            B, CAP, G, 2, 6 * G)

    def z(n):
        return torch.zeros((B, CAP, G, 2, n), dtype=dtype, device=s.P.device)
    Hx = torch.cat([z(L.WBC), HWbc * w, HTbc * w,
                    z(L.GROUP_BEGIN - (L.WBC + 6)), Hgrp,
                    z(D - L.GROUP_BEGIN - 6 * G)], dim=-1)
    return _finish_rows(cfg, Hx.reshape(B, CAP, 2 * G, D),
                        (Hf * w).reshape(B, CAP, 2 * G, 3),
                        (inn * good.to(dtype)[..., None]).reshape(
                            B, CAP, 2 * G),
                        torch.sum(good.to(torch.int64), dim=-1))


def _finish_rows(cfg: VIOConfig, Hx, Hf, inn, nobs):
    """Project onto the landmark's left nullspace, keep rows of features
    with enough observations and a nonzero row, and pad back to 2G rows.
    Hx (..., 2G, D), Hf (..., 2G, 3), inn (..., 2G), nobs (...)."""
    Ho, inn_o = _householder_nullspace(Hf, Hx, inn)
    enough = nobs >= cfg.OOS_min_observations
    valid = (torch.linalg.vector_norm(Ho, dim=-1) > 1e-10) & enough[..., None]
    Ho = torch.where(valid[..., None], Ho, 0.0)
    inn_o = torch.where(valid, inn_o, 0.0)
    lead = Ho.shape[:-2]
    pad = torch.zeros(lead + (3,), dtype=Ho.dtype, device=Ho.device)
    return (torch.cat([Ho, torch.zeros(lead + (3, Ho.shape[-1]),
                                       dtype=Ho.dtype, device=Ho.device)],
                      dim=-2),
            torch.cat([inn_o, pad], dim=-1),
            torch.cat([valid, pad > 0], dim=-1))


def _oos_rows_for_feature(cfg: VIOConfig, s: VIOState, row):
    """Nullspace-projected OOS rows of one feature-table row per sequence
    (row (B,), -1 for none), slot by slot as the reference writes it:
    (Ho (B, 2G, D), inn (B, 2G), row_valid (B, 2G)). ``_oos_rows_all``
    computes the same for all candidates at once."""
    d = cfg.dims
    G, D = d.n_groups, d.full
    dtype = s.P.dtype
    kind = cam_mod.MODEL_IDS[cfg.cam_model]
    fr, gr = s.features, s.groups
    NG = gr.gid.shape[-1]
    b = torch.arange(row.shape[0], device=row.device)
    rowc = torch.clamp(row, min=0)
    gref = torch.clamp(fr.ref[b, rowc], 0, NG - 1)
    Xc, _ = unproject_logz(fr.x[b, rowc])
    Rbc, Tbc = s.X.Rbc, s.X.Tbc
    Rbc_t = Rbc.transpose(-1, -2)

    def anchored(Rs, Ts):
        R = Rs[b, gref]
        return mv(R @ Rbc, Xc) + mv(R, Tbc) + Ts[b, gref]

    fej = cfg.use_fej and cfg.oos_fej
    Xs = anchored(gr.Rsb, gr.Tsb)
    Xs_l = anchored(gr.Rsb_fej, gr.Tsb_fej) if fej else Xs
    zhat = constant((0.0, 0.0, 1.0), dtype, s.P.device)

    def per_slot(j):
        grow = s.g2row[:, j]
        growc = torch.clamp(grow, min=0)
        seen = fr.adj[b, rowc, growc] & (grow >= 0)
        Rg, Tg = gr.Rsb[b, growc], gr.Tsb[b, growc]
        Xb = mv(Rg.transpose(-1, -2), Xs - Tg)
        Xcn = mv(Rbc_t, Xb - Tbc)
        good = seen & (Xcn[:, 2] > 1e-6)
        Xcn_s = torch.where(good[:, None], Xcn, zhat)
        xcn, dxcn_dXcn = project_persp(Xcn_s)
        xp_pred, dxp_dxcn, _ = cam_mod.project_with_jac(kind, s.cam, xcn)
        if fej:
            # the Jacobian chain at the group's first pose estimate
            Rg_l, Tg_l = gr.Rsb_fej[b, growc], gr.Tsb_fej[b, growc]
            Xb_l = mv(Rg_l.transpose(-1, -2), Xs_l - Tg_l)
            Xcn_l = mv(Rbc_t, Xb_l - Tbc)
            good = good & (Xcn_l[:, 2] > 1e-6)
            Xcn_l = torch.where(good[:, None], Xcn_l, zhat)
            xcn_l, dxcn_dXcn_l = project_persp(Xcn_l)
            _, dxp_dxcn_l, _ = cam_mod.project_with_jac(kind, s.cam, xcn_l)
            dxp_dXcn = dxp_dxcn_l @ dxcn_dXcn_l
        else:
            Rg_l, Xb_l, Xcn_l = Rg, Xb, Xcn_s
            dxp_dXcn = dxp_dxcn @ dxcn_dXcn
        Rg_lt = Rg_l.transpose(-1, -2)
        Hf = dxp_dXcn @ Rbc_t @ Rg_lt                        # w.r.t. Xs
        HW = dxp_dXcn @ Rbc_t @ so3.hat(Xb_l)                # group W
        HT = dxp_dXcn @ Rbc_t @ (-Rg_lt)                     # group T
        HWbc = dxp_dXcn @ so3.hat(Xcn_l)
        HTbc = dxp_dXcn @ (-Rbc_t)
        goff = L.GROUP_BEGIN + 6 * j
        zero = torch.zeros(HW.shape[:-1] + (D,), dtype=dtype,
                           device=s.P.device)
        Hx = torch.cat([zero[..., :L.WBC], HWbc, HTbc,
                        zero[..., L.WBC + 6:goff], HW, HT,
                        zero[..., goff + 6:]], dim=-1)
        w = good.to(dtype)
        return (Hx * w[:, None, None], Hf * w[:, None, None],
                (fr.adj_xp[b, rowc, growc] - xp_pred) * w[:, None], good)

    Hx, Hf, inn, good = zip(*(per_slot(j) for j in range(G)))
    nobs = torch.sum(torch.stack(good, -1).to(torch.int64), dim=-1)
    return _finish_rows(cfg, torch.cat(Hx, -2), torch.cat(Hf, -2),
                        torch.cat(inn, -1), nobs)


def oos_update(cfg: VIOConfig, s: VIOState, candidate_rows):
    """Joint MSCKF update over the frame's dying features (candidate_rows
    (B, NF)). At most cfg.oos_feature_cap candidates a sequence, the ones
    with the most instate observations first. Returns (state, n_dropped
    (B,)): the candidates beyond the cap, for StepOutputs.num_oos_dropped.
    Sequences with no valid row keep their state exactly."""
    from .pipeline import _place_one_hot, _rank_assign

    CAP = cfg.oos_feature_cap
    d = cfg.dims
    D = d.full
    fr, gr = s.features, s.groups
    dtype = s.P.dtype
    B = s.P.shape[0]

    nobs = torch.sum((fr.adj & gr.instate[:, None, :]).to(torch.int64), -1)
    cand = candidate_rows & (nobs >= cfg.OOS_min_observations)
    n_dropped = torch.clamp(torch.sum(cand.to(torch.int64), -1) - CAP, min=0)
    slot_of_row, got = _rank_assign(
        torch.ones((B, CAP), dtype=torch.bool, device=cand.device), cand,
        -nobs.to(dtype))
    _, _, row_of_slot = _place_one_hot(
        torch.where(got, slot_of_row, CAP), CAP,
        torch.full((B, CAP), -1, dtype=torch.int64, device=cand.device))

    ok = row_of_slot >= 0
    Ho, inn_o, valid = _oos_rows_all(cfg, s, row_of_slot)
    okf = ok.to(dtype)[..., None]
    Ho = (Ho * okf[..., None]).reshape(B, -1, D)
    inn_o = (inn_o * okf).reshape(B, -1)
    rv = (valid & ok[..., None]).reshape(B, -1)

    Roos = cfg.oos_meas_std ** 2
    Hm = Ho * rv[..., None].to(dtype)
    innm = inn_o * rv.to(dtype)
    diagRm = torch.where(rv, Roos, 1.0).to(dtype)
    if cfg.use_oc_meas:
        # the group blocks here sit at the current estimates, which drift
        # between updates: forcing H N(fej) = 0 keeps these rows from
        # leaking global translation / yaw information
        Hm = oc_project_rows(Hm, oc_nullspace(cfg, s))

    if cfg.use_compression and Hm.shape[-2] > int(
            cfg.compression_trigger_ratio * D):
        # measurement compression: with iid noise the update depends on H
        # only through H^T H and H^T inn, so one masked Cholesky of the
        # bordered Gram [[H^T H, H^T inn], [., |inn|^2]] = [[L, 0], [w^T,
        # .]] gives Hc = L^T and innc = w = L^-1 H^T inn (kernel B1 at
        # (D + 1)^2)
        Mb = torch.cat([Hm, innm[..., None]], dim=-1)       # (B, rows, D+1)
        Gb = Mb.transpose(-1, -2) @ Mb
        rel = 1e-12 if dtype == torch.float64 else 1e-6
        Gb = Gb + torch.diag_embed(
            rel * torch.diagonal(Gb, dim1=-2, dim2=-1))
        Lb = lanes_chol.chol_lanes(Gb.contiguous())
        Hm = Lb[:, :D, :D].transpose(-1, -2)                # (B, D, D) upper
        innm = Lb[:, D, :D]
        rv = torch.linalg.vector_norm(Hm, dim=-1) > 1e-10
        diagRm = torch.where(rv, Roos, 1.0).to(dtype)
        Hm = Hm * rv[..., None].to(dtype)
        innm = innm * rv.to(dtype)

    # rows here are single, not 2-row feature pairs: both updates mask
    # each row on its own
    if s.P.shape[-1] == s.P.shape[-2]:
        err, P = joseph_rows(s.P, Hm, innm, diagRm, rv)
    else:
        err, P = sqrt_update(s.P, Hm, innm, diagRm, rv)
    do = torch.any(rv, dim=-1)
    err = torch.where(do[:, None], err, 0.0)
    P = where_state(do, P, s.P)
    return absorb_error(cfg, s._replace(P=P), err), n_dropped
