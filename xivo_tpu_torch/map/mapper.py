"""Sparse map + loop closure (port of ``xivo_tpu/map/mapper.py``).

Retired features live in a fixed-capacity table per sequence; loop-closure
candidates come from exact Hamming matching of the descriptors (kernel
B6, ``ops/hamming.hamming_nn``); geometric verification is the vectorized
P3P RANSAC; accepted matches become EKF rows against the current pose
(CloseLoopInternal, src/update.cpp:171-210). Every function takes the
state and the map with a leading batch axis B (``runner.batch_maps``);
``init_map`` builds one sequence's map.

The reference's ``.at[idx].set`` drops an out-of-range index M ("trash");
here a scatter writes into one extra row that is then cut off
(``_scatter_rows``).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .. import resolve_device
from ..cam import models as cam_mod
from ..filter import layout as L
from ..filter.config import VIOConfig
from ..filter.features import project_persp, unproject_logz
from ..filter.state import VIOState, where_state
from ..filter.update import (absorb_error, innovation_blocks,
                             measurement_update)
from ..geom import so3
from ..ops.dense import adjugate3, constant, take_rows
from ..ops import hamming
from .p3p import pnp_ransac


class MapState(NamedTuple):
    Xs: torch.Tensor         # (B,M,3) landmark positions (spatial frame)
    cov: torch.Tensor        # (B,M,3,3) landmark position covariance
    desc: torch.Tensor       # (B,M,8) 32-bit descriptor words in int64
    gid: torch.Tensor        # (B,M) int64 anchor group id at retirement
    epoch: torch.Tensor      # (B,M) int64 vision_counter at insertion
    valid: torch.Tensor      # (B,M) bool
    write_ptr: torch.Tensor  # (B,) ring pointer
    count: torch.Tensor      # (B,) total inserted (diagnostic)
    n_merged: torch.Tensor   # (B,) fusion events (diagnostic)


def init_map(capacity: int = 20000, dtype=torch.float32,
             device="cuda") -> MapState:
    """An empty map of ONE sequence (no batch axis);
    ``runner.batch_maps`` stacks B of these."""
    dev = resolve_device(device)
    i64 = dict(dtype=torch.int64, device=dev)
    zero = torch.zeros((), **i64)
    return MapState(
        Xs=torch.zeros((capacity, 3), dtype=dtype, device=dev),
        cov=torch.zeros((capacity, 3, 3), dtype=dtype, device=dev),
        desc=torch.zeros((capacity, 8), **i64),
        gid=torch.full((capacity,), -1, **i64),
        epoch=torch.zeros((capacity,), **i64),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=dev),
        write_ptr=zero, count=zero.clone(), n_merged=zero.clone())


def _scatter_rows(arr, tgt, val):
    """``arr.at[b, tgt[b, k]].set(val[b, k])`` for arr (B, M, ...), tgt
    (B, K) in [0, M] where M drops the row; the result is contiguous, as
    the Hamming kernel takes the tables."""
    ext = torch.cat([arr, arr[:, :1]], dim=1)
    idx = tgt.reshape(tgt.shape + (1,) * (arr.dim() - 2)).expand(
        tgt.shape + arr.shape[2:])
    return ext.scatter_(1, idx, val.to(arr.dtype))[:, :arr.shape[1]] \
        .contiguous()


def _inv3(A):
    """Closed-form 3x3 inverse (adjugate/det), batched."""
    co, det = adjugate3(A)
    det = torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30),
                      det)
    return co / det[..., None, None]


def map_insert(ms: MapState, Xs, desc, valid, cov=None, gid=None,
               nn_dist_thresh: int = -1, merge_radius: float = 0.5,
               epoch=None) -> MapState:
    """Insert a batch of retired landmarks Xs (B, n, 3), FUSING re-retired
    ones (merge-on-retirement, src/mapper.cpp:158-222 + Feature::Merge,
    src/feature.cpp:187-208): a new landmark whose descriptor matches an
    existing entry (Hamming < nn_dist_thresh) within merge_radius meters
    is covariance-weighted fused into it, one candidate per target (the
    lowest distance, then the lowest row); the others ring-insert.
    nn_dist_thresh < 0 disables fusion."""
    B, M = ms.valid.shape
    n = Xs.shape[1]
    dtype, dev = ms.Xs.dtype, ms.Xs.device
    Xs = Xs.to(dtype)
    cov = torch.zeros((B, n, 3, 3), dtype=dtype, device=dev) \
        if cov is None else cov.to(dtype)
    if gid is None:
        gid = torch.full((B, n), -1, dtype=torch.int64, device=dev)
    if epoch is None:
        epoch = torch.zeros((B,), dtype=torch.int64, device=dev)
    epoch = epoch.to(torch.int64)[:, None].expand(B, n)

    if nn_dist_thresh >= 0:
        # only the retiring rows' matches are read (merge needs `valid`)
        nnd, nn = hamming.hamming_nn(desc.contiguous(), ms.desc, ms.valid,
                                     qmask=valid.contiguous())
        X1 = take_rows(ms.Xs, nn)
        P1 = take_rows(ms.cov, nn)
        close = torch.linalg.vector_norm(Xs - X1, dim=-1) < merge_radius
        merge = valid & (nnd < nn_dist_thresh) & close
        # one fusion per target: the lowest distance, then the lowest row
        idx = torch.arange(n, device=dev)
        same_tgt = merge[..., :, None] & merge[..., None, :] \
            & (nn[..., :, None] == nn[..., None, :])
        beaten = same_tgt & ((nnd[..., None, :] < nnd[..., :, None])
                             | ((nnd[..., None, :] == nnd[..., :, None])
                                & (idx[None, :] < idx[:, None])))
        merge = merge & ~torch.any(beaten, dim=-1)
        # x+ = x1 + P1 (P1+P2)^-1 (x2 - x1), Joseph-form P+, with the
        # reference's relative jitter on P1 + P2
        S12 = P1 + cov
        tr12 = (S12[..., 0, 0] + S12[..., 1, 1] + S12[..., 2, 2]) / 3.0
        rel = 1e-9 if dtype == torch.float64 else 1e-5
        eps = (rel * tr12 + 1e-12)[..., None, None]
        eye3 = torch.eye(3, dtype=dtype, device=dev)
        K = P1 @ _inv3(S12 + eps * eye3)
        x_f = X1 + (K @ (Xs - X1)[..., None])[..., 0]
        IK = eye3 - K
        P_f = IK @ P1 @ IK.transpose(-1, -2) + K @ cov @ K.transpose(-1, -2)
        P_f = 0.5 * (P_f + P_f.transpose(-1, -2))
        tgt_m = torch.where(merge, nn, M)
        ms = ms._replace(
            Xs=_scatter_rows(ms.Xs, tgt_m, x_f),
            cov=_scatter_rows(ms.cov, tgt_m, P_f),
            desc=_scatter_rows(ms.desc, tgt_m, desc),   # freshest view wins
            # epoch is birth time: fusion never refreshes it
            n_merged=ms.n_merged + torch.sum(merge.to(torch.int64), -1))
        valid = valid & ~merge

    nvalid = torch.sum(valid.to(torch.int64), -1)
    rank = torch.cumsum(valid.to(torch.int64), -1) - 1
    tgt = torch.where(valid, (ms.write_ptr[:, None] + rank) % M, M)
    return ms._replace(
        Xs=_scatter_rows(ms.Xs, tgt, Xs),
        cov=_scatter_rows(ms.cov, tgt, cov),
        desc=_scatter_rows(ms.desc, tgt, desc),
        gid=_scatter_rows(ms.gid, tgt, gid),
        epoch=_scatter_rows(ms.epoch, tgt, epoch),
        valid=_scatter_rows(ms.valid, tgt, torch.ones_like(valid)),
        write_ptr=(ms.write_ptr + nvalid) % M,
        count=ms.count + nvalid)


def detect_loop_closures(cfg: VIOConfig, s: VIOState, ms: MapState,
                         uniforms, nn_dist_thresh: int = 30,
                         ransac_thresh: float = 0.03, min_matches: int = 5,
                         matcher=None):
    """Descriptor matching + P3P verification
    (Mapper::DetectLoopClosures, src/mapper.cpp:335-418). The queries are
    the in-state features, by EKF slot; ``uniforms`` (B, n_hyps, F) are
    the RANSAC draws. Returns (query rows, map index, inlier mask, any
    loop), each (B, F) but the last (B,). ``matcher``, from
    ``dist/retrieval.make_sharded_matcher``, searches the map split over
    the ranks of a process group in place of the single search."""
    fr = s.features
    kind = cam_mod.MODEL_IDS[cfg.cam_model]
    qok = s.f2row >= 0
    qrow = torch.clamp(s.f2row, min=0)
    qdesc = take_rows(fr.desc, qrow)
    qxp = take_rows(fr.xp, qrow)

    # age gate: entries younger than lc_min_age_frames restate what the
    # filter still holds
    mvalid = ms.valid
    if cfg.lc_min_age_frames > 0:
        mvalid = mvalid & (ms.epoch <= (s.vision_counter
                                        - cfg.lc_min_age_frames)[:, None])
    if matcher is None:
        nnd, nn = hamming.hamming_nn(qdesc, ms.desc, mvalid)
    else:
        nn, nnd = matcher(qdesc, ms.desc, mvalid)
    match = qok & (nnd < nn_dist_thresh)
    n_match = torch.sum(match.to(torch.int64), -1)

    xcn = cam_mod.unproject(kind, s.cam[:, None], qxp)
    v = torch.cat([xcn, torch.ones_like(xcn[..., :1])], dim=-1)
    bear = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    Xw = take_rows(ms.Xs, nn).to(bear.dtype)
    _, _, inl, okr = pnp_ransac(uniforms, Xw, bear, match,
                                inlier_thresh=ransac_thresh,
                                min_inliers=min_matches)
    good = (n_match >= min_matches) & okr
    inlier = match & inl & good[:, None]
    # the reference discards when <= 4 geometric inliers survive
    enough = torch.sum(inlier.to(torch.int64), -1) > 4
    inlier = inlier & enough[:, None]
    return qrow, nn, inlier, torch.any(inlier, dim=-1)


def close_loop(cfg: VIOConfig, s: VIOState, ms: MapState, uniforms,
               **detect_kw) -> Tuple[VIOState, torch.Tensor]:
    """Full CloseLoop step: detect + EKF rows against the current pose,
    measurement noise Rlc plus the landmark's projected covariance, the
    anchor-pose block only with ``cfg.lc_anchor_rows``, and the chi-square
    gate ``cfg.lc_MH_thresh`` (see the reference's docstring). Returns
    (state, closure rows used (B,))."""
    d = cfg.dims
    F, G, D = d.n_features, d.n_groups, d.full
    dtype = s.P.dtype
    kind = cam_mod.MODEL_IDS[cfg.cam_model]
    fr, gr = s.features, s.groups
    NG = gr.gid.shape[-1]
    B = s.P.shape[0]

    qrow, nn, inlier, _ = detect_loop_closures(cfg, s, ms, uniforms,
                                               **detect_kw)
    Rbc_t = s.X.Rbc.transpose(-1, -2)[:, None]                # (B,1,3,3)
    Rsb_t = s.X.Rsb.transpose(-1, -2)[:, None]

    Xs_old = take_rows(ms.Xs, nn).to(dtype)                   # (B,F,3)
    cov_w = take_rows(ms.cov, nn).to(dtype)
    xp_meas = take_rows(fr.xp, qrow)
    Xb = (Rsb_t @ (Xs_old - s.X.Tsb[:, None])[..., None])[..., 0]
    Xcn = (Rbc_t @ (Xb - s.X.Tbc[:, None])[..., None])[..., 0]
    front = Xcn[..., 2] > 1e-6
    Xcn_s = torch.where(front[..., None], Xcn,
                        constant((0.0, 0.0, 1.0), dtype, Xcn.device))
    xcn, dxcn_dXcn = project_persp(Xcn_s)
    xp_pred, dxp_dxcn, _ = cam_mod.project_with_jac(kind, s.cam[:, None],
                                                    xcn)
    dxp_dXcn = dxp_dxcn @ dxcn_dXcn                           # (B,F,2,3)
    Hxs = dxp_dXcn @ (Rbc_t @ Rsb_t)
    H = torch.zeros((B, F, 2, D), dtype=dtype, device=s.P.device)
    H[..., L.WSB:L.WSB + 3] = dxp_dXcn @ Rbc_t @ so3.hat(Xb)
    H[..., L.TSB:L.TSB + 3] = -Hxs
    H[..., L.WBC:L.WBC + 3] = dxp_dXcn @ so3.hat(Xcn_s)
    H[..., L.TBC:L.TBC + 3] = dxp_dXcn @ (-Rbc_t)
    use = inlier
    w = (use & front).to(dtype)
    H = H * w[..., None, None]

    if cfg.lc_anchor_rows:
        # anchor-pose block: the landmark re-expressed in its anchor group,
        # while that group is still in the EKF window
        agid = take_rows(ms.gid, nn)
        eq = (agid[..., :, None] == gr.gid[..., None, :]) \
            & (agid >= 0)[..., None] & (gr.gid >= 0)[..., None, :]
        has_anchor = torch.any(eq, dim=-1)
        arow = torch.clamp(torch.argmax(eq.to(torch.int32), dim=-1), 0,
                           NG - 1)
        aslot = torch.where(has_anchor, take_rows(gr.sind, arow), -1)
        alive = has_anchor & (aslot >= 0)
        Rg = take_rows(gr.Rsb, arow)
        Tg = take_rows(gr.Tsb, arow)
        Xb_a = (Rg.transpose(-1, -2) @ (Xs_old - Tg)[..., None])[..., 0]
        aw = (alive & use).to(dtype)[..., None, None]
        Hg = torch.cat([Hxs @ (-Rg @ so3.hat(Xb_a)) * aw, Hxs * aw], -1)
        Hg = Hg * w[..., None, None]
        gslot = torch.clamp(aslot, 0, G - 1)
        oh = (gslot[..., None] == torch.arange(G, device=gslot.device)).to(
            dtype) * torch.any(torch.abs(Hg) > 0, dim=(-2, -1)).to(
            dtype)[..., None]
        Hgrp = torch.einsum("bfg,bfrk->bfrgk", oh, Hg).reshape(B, F, 2, 6 * G)
        H[..., L.GROUP_BEGIN:L.GROUP_BEGIN + 6 * G] += Hgrp

    Rrow = cfg.Rlc + torch.clamp(torch.diagonal(
        Hxs @ cov_w @ Hxs.transpose(-1, -2), dim1=-2, dim2=-1), min=0.0)
    inn = (xp_meas - xp_pred) * w[..., None]
    H = H.reshape(B, 2 * F, D)
    inn = inn.reshape(B, 2 * F)
    diagR = Rrow.reshape(B, 2 * F).to(dtype)
    rv = use & front
    if cfg.lc_MH_thresh > 0:
        # chi-square gate on each closure's 2x2 innovation
        b00, b01, b11 = innovation_blocks(s.P, H)
        S00 = b00 + diagR[:, 0::2]
        S01 = b01
        S11 = b11 + diagR[:, 1::2]
        r0, r1 = inn[:, 0::2], inn[:, 1::2]
        det = S00 * S11 - S01 * S01
        det = torch.where(torch.abs(det) < 1e-12,
                          torch.full_like(det, 1e-12), det)
        dist = (S11 * r0 * r0 - 2.0 * S01 * r0 * r1 + S00 * r1 * r1) / det
        rv = rv & (dist < cfg.lc_MH_thresh)
    err, P = measurement_update(s.P, H, inn, diagR, rv)
    do = torch.any(rv, dim=-1)
    err = torch.where(do[:, None], err, 0.0)
    P = where_state(do, P, s.P)
    s = absorb_error(cfg, s._replace(P=P), err)
    return s, torch.sum(rv.to(torch.int64), -1)


def retire_features(cfg: VIOConfig, s: VIOState, ms: MapState,
                    row_mask) -> MapState:
    """Push feature-table rows (mask (B, NF)) into the map with their
    spatial positions, position covariance (the EKF block for in-state
    rows, the subfilter's otherwise, pushed through the local-to-world
    chain to first order), anchor group id and descriptors
    (Mapper::AddFeature, src/mapper.cpp:158-240)."""
    fr, gr = s.features, s.groups
    NG = gr.gid.shape[-1]
    d = cfg.dims
    F, fb = d.n_features, d.feature_begin
    B = s.P.shape[0]
    grow = torch.clamp(fr.ref, 0, NG - 1)

    if s.P.shape[-1] == s.P.shape[-2]:
        # the diagonal 3x3 blocks of the dense feature block
        blocks = torch.diagonal(
            s.P[:, fb:fb + 3 * F, fb:fb + 3 * F].reshape(B, F, 3, F, 3),
            dim1=1, dim2=3).permute(0, 3, 1, 2)
    else:
        rows3 = s.P[:, fb:fb + 3 * F].reshape(B, F, 3, -1)
        blocks = rows3 @ rows3.transpose(-1, -2)              # (B,F,3,3)
    Pblk = take_rows(blocks, torch.clamp(fr.sind, 0, F - 1))
    Pblk = torch.where((fr.sind >= 0)[..., None, None], Pblk,
                       fr.Psub.to(Pblk.dtype))

    Xc, dXc_dx = unproject_logz(fr.x)
    R = take_rows(gr.Rsb, grow)
    T = take_rows(gr.Tsb, grow)
    Rbc = s.X.Rbc[:, None]
    Xs = (R @ ((Rbc @ Xc[..., None])[..., 0]
               + s.X.Tbc[:, None])[..., None])[..., 0] + T
    J = R @ Rbc @ dXc_dx
    cov = J @ Pblk @ J.transpose(-1, -2)
    gid = torch.where(fr.ref >= 0, take_rows(gr.gid, grow), -1)
    ok = row_mask & (fr.ref >= 0)
    return map_insert(ms, Xs, fr.desc, ok, cov=cov, gid=gid,
                      nn_dist_thresh=(cfg.lc_nn_dist_thresh
                                      if cfg.map_merge_on_retire else -1),
                      merge_radius=cfg.map_merge_radius,
                      epoch=s.vision_counter)
