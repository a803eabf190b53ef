"""The per-frame VIO pipeline (port of ``xivo_tpu/filter/pipeline.py``).

Every function takes the state with a leading batch axis B: the
reference's ``vmap`` over sequences written out. Each ``lax.cond`` of the
reference is, under ``vmap``, a select; here both sides are computed and
``where_state`` picks per batch item. Nothing in a frame reads a value
back to the host, so a run of frames enqueues device work without a sync.

Slot/row conventions as in the reference: "row" indexes the feature/group
tables (graph capacity); "slot" indexes the EKF window.

The stages are ``tracing`` spans (``PROPAGATE``, ``TRACKER``, ``UPDATE``),
and so are the parts of fast propagation and of the update step; the
stage functions stay module attributes under their names.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .. import tracing
from ..cam import models as cam_mod
from ..geom import so3
from ..ops.dense import constant, take_rows
from ..ops.imu_chain import chain_plain, imu_chain
from . import layout as L
from .config import VIOConfig
from .features import (bcast_X, change_owner, subfilter_update_table,
                       triangulate_two_view_checked)
from .propagate import (imu_sample_update, oc_correct_phi,
                        propagate_interval_fast, propagate_state,
                        qmodel_diag, with_motion_block)
from .sqrt_form import (chol3x3, cov_diag, factor_propagate_absorb,
                        feature_band, is_sqrt)
from .state import (FS_CREATED, FS_EMPTY, FS_GAUGE, FS_INITIALIZING,
                    FS_INSTATE, FS_READY, TS_CREATED, TS_DROPPED, TS_NONE,
                    TS_TRACKED, FeatureTable, VIOState, check_supported,
                    where_state)
from .update import (absorb_error, build_stacked_jacobian,
                     huber_robustify_R, measurement_update, mh_distances,
                     mh_gate, zero_state_entries)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _arange(n, like):
    return torch.arange(n, device=like.device)


def _first_true(mask):
    """Index of the first True along the last axis (0 if none), as
    ``jnp.argmax`` of a bool array."""
    return torch.argmax(mask.to(torch.int32), dim=-1)


def _onehot_rows(idx, n):
    """(..., K) int -> (..., K, n) bool, idx == column."""
    return idx[..., None] == _arange(n, idx)


def _set_row(arr, row, value):
    """arr (B, N, ...) with arr[b, row[b]] = value[b] (value (B, ...))."""
    hit = _onehot_rows(row[:, None], arr.shape[1])[:, 0]          # (B, N)
    hit = hit.reshape(hit.shape + (1,) * (arr.dim() - 2))
    return torch.where(hit, value[:, None], arr)


def _rank_by_key(valid_mask, order_key):
    """Stable ascending rank of each item among all items (invalid items
    get key=+inf), by a pairwise comparison matrix."""
    N = valid_mask.shape[-1]
    key = torch.where(valid_mask, order_key.to(torch.float64), torch.inf)
    idx = _arange(N, key)
    before = (key[..., None, :] < key[..., :, None]) \
        | ((key[..., None, :] == key[..., :, None])
           & (idx[None, :] < idx[:, None]))
    return torch.sum(before, dim=-1), before


def _rank_assign(free_mask, want_mask, order_key):
    """Assign wanted items (B, N) to free slots (B, S) in priority order
    (smaller key first). Returns (slot_of_item, got); slot S = trash."""
    S = free_mask.shape[-1]
    rank_of_item, _ = _rank_by_key(want_mask, order_key)
    free_rank = torch.cumsum(free_mask.to(torch.int64), dim=-1) - 1
    n_free = torch.sum(free_mask.to(torch.int64), dim=-1, keepdim=True)
    got = want_mask & (rank_of_item < n_free)
    match = free_mask[..., None, :] \
        & (free_rank[..., None, :] == rank_of_item[..., :, None])
    slot_i = torch.sum(match * _arange(S, match), dim=-1)
    return torch.where(got, slot_i, torch.full_like(slot_i, S)), got


def _place_one_hot(tgt_slot, n_slots, old_map):
    """``old_map.at[tgt_slot].set(arange(N))`` with trash index n_slots:
    returns (new_map, hit_mask, row_of_slot) (row_of_slot -1 if unhit)."""
    N = tgt_slot.shape[-1]
    oh = tgt_slot[..., :, None] == _arange(n_slots, tgt_slot)  # (B, N, S)
    hit = torch.any(oh, dim=-2)
    rowidx = torch.sum(oh * _arange(N, oh)[:, None], dim=-2)
    return (torch.where(hit, rowidx, old_map), hit,
            torch.where(hit, rowidx, torch.full_like(rowidx, -1)))


def _slot_mask_of_rows(row_mask, sind, n_slots):
    """(B, n_slots) mask of the EKF slots held by the masked rows."""
    return torch.any(row_mask[..., :, None]
                     & (sind[..., :, None] == _arange(n_slots, sind)),
                     dim=-2)


def _keep_block(cfg: VIOConfig, begin: int, width: int, slot_mask, dtype):
    """(B, D) keep-vector zeroing the `width` entries of each masked slot of
    the block starting at `begin`."""
    d = cfg.dims
    B = slot_mask.shape[0]
    block = slot_mask[..., None].expand(slot_mask.shape + (width,)).reshape(
        B, -1)
    keep = torch.ones((B, d.full), dtype=dtype, device=slot_mask.device)
    return torch.cat([keep[:, :begin],
                      torch.where(block, 0.0, 1.0).to(dtype),
                      keep[:, begin + block.shape[1]:]], dim=1)


def _feature_keep_vector(cfg: VIOConfig, slot_mask, dtype):
    return _keep_block(cfg, cfg.dims.feature_begin, 3, slot_mask, dtype)


def _group_keep_vector(cfg: VIOConfig, slot_mask, dtype):
    return _keep_block(cfg, L.GROUP_BEGIN, 6, slot_mask, dtype)


def _where(mask, a, b):
    """torch.where with the mask broadcast over a's trailing axes."""
    m = mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim()))
    return torch.where(m, a, b)


def _clear_feature_rows(fr: FeatureTable, m) -> FeatureTable:
    """Reset table rows where m is True (Feature::Destroy parity)."""
    def full(x, v):
        return torch.where(m, torch.full_like(x, v), x)
    return fr._replace(
        fid=full(fr.fid, -1), status=full(fr.status, FS_EMPTY),
        track=full(fr.track, TS_NONE), ref=full(fr.ref, -1),
        sind=full(fr.sind, -1), init_counter=full(fr.init_counter, 0),
        lifetime=full(fr.lifetime, 0),
        outlier_counter=full(fr.outlier_counter, 0.0),
        tri_ok=fr.tri_ok & ~m, adj=fr.adj & ~m[..., None],
        sim_depth=full(fr.sim_depth, -1.0))


def _remove_features_from_state(cfg: VIOConfig, s: VIOState, row_mask):
    """Free EKF slots of the masked feature rows + zero their covariance
    (RemoveFeatureFromState, src/estimator.cpp:762-783)."""
    fr = s.features
    hit = row_mask & (fr.sind >= 0)
    slot_mask = _slot_mask_of_rows(hit, fr.sind, cfg.dims.n_features)
    P = zero_state_entries(
        s.P, _feature_keep_vector(cfg, slot_mask, s.P.dtype) > 0)
    f2row = torch.where(slot_mask, -1, s.f2row)
    fr = fr._replace(sind=torch.where(hit, -1, fr.sind),
                     status=torch.where(hit, FS_READY, fr.status))
    return s._replace(P=P, f2row=f2row, features=fr)


def _remove_groups_from_state(cfg: VIOConfig, s: VIOState, grow_mask):
    """Free EKF slots of the masked group rows (RemoveGroupFromState)."""
    gr = s.groups
    hit = grow_mask & (gr.sind >= 0)
    slot_mask = _slot_mask_of_rows(hit, gr.sind, cfg.dims.n_groups)
    P = zero_state_entries(
        s.P, _group_keep_vector(cfg, slot_mask, s.P.dtype) > 0)
    g2row = torch.where(slot_mask, -1, s.g2row)
    gr = gr._replace(sind=torch.where(hit, -1, gr.sind),
                     is_clone=gr.is_clone & ~hit)
    # losing the gauge group resets the gauge (src/estimator.cpp:1320-1324)
    lost_gauge = torch.any(hit & (_arange(hit.shape[-1], hit)
                                  == s.gauge_row[:, None]), dim=-1)
    gauge_row = torch.where(lost_gauge, -1, s.gauge_row)
    return s._replace(P=P, g2row=g2row, groups=gr, gauge_row=gauge_row)


# ---------------------------------------------------------------------------
# tracker (POINTCLOUD mode)
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """Low 32 bits of x * c for x in [0, 2^32) held in int64, without
    overflowing int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _splitmix32(x):
    x = (x + 0x9e3779b9) & _MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x21f0aaad)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x735a2d97)
    return x ^ (x >> 15)


def reject_outliers(cfg: VIOConfig, xp_prev, xp_new, tracked, uniforms):
    """Homography-consistency rejection of tracked rows
    (Tracker::OutlierRejection, src/tracker.cpp:705-753) when
    ``cfg.do_outlier_rejection``: returns (the tracked rows that remain,
    the count rejected (B,))."""
    if not cfg.do_outlier_rejection:
        return tracked, torch.zeros(tracked.shape[:-1], dtype=torch.int64,
                                    device=tracked.device)
    from ..frontend.homography import homography_ransac
    if uniforms is None:
        raise ValueError("do_outlier_rejection needs the frame's homography "
                         "draws (hom_uniforms)")
    inl, _ = homography_ransac(uniforms, xp_prev, xp_new, tracked,
                               thresh=cfg.homography_reproj_thresh)
    n_rej = torch.sum((tracked & ~inl).to(torch.int64), dim=-1)
    return tracked & inl, n_rej


@tracing.span(tracing.TRACKER)
def tracker_pointcloud(cfg: VIOConfig, s: VIOState, meas_id, meas_xp,
                       meas_depth, meas_valid, hom_uniforms=None) -> VIOState:
    """Id-keyed synthetic measurement association
    (Tracker::UpdatePointCloud, src/tracker.cpp:632-702). With
    ``cfg.do_outlier_rejection``, the matched tracks inconsistent with the
    frame's homography are dropped (``frontend/homography.py``; the
    reference applies the LK tracker's rejection in this mode too), from
    the draws `hom_uniforms` (B, N_HYPS, NF)."""
    fr = s.features
    NF = fr.fid.shape[-1]
    M = meas_id.shape[-1]
    dtype = fr.xp.dtype

    active = fr.active
    eq = (fr.fid[..., :, None] == meas_id[..., None, :]) \
        & active[..., :, None] & meas_valid[..., None, :]    # (B, NF, M)
    has_match = torch.any(eq, dim=-1)
    mj = torch.clamp(_first_true(eq), 0, M - 1)
    mxp = take_rows(meas_xp, mj)
    mdepth = take_rows(meas_depth, mj)

    disp_ok = torch.linalg.vector_norm(mxp - fr.xp, dim=-1) \
        < cfg.max_pixel_displacement
    tracked = has_match & disp_ok
    tracked, n_rej = reject_outliers(cfg, fr.xp, mxp, tracked, hom_uniforms)
    s = s._replace(n_tracker_rejected=n_rej)
    dropped = active & ~tracked

    fr = fr._replace(
        track=torch.where(tracked, TS_TRACKED,
                          torch.where(dropped, TS_DROPPED, fr.track)),
        xp=_where(tracked, mxp.to(dtype), fr.xp),
        sim_depth=torch.where(tracked, mdepth.to(dtype), fr.sim_depth))

    claimed = torch.any(eq & tracked[..., :, None], dim=-2)
    to_create = meas_valid & ~claimed
    n_live = torch.sum(tracked.to(torch.int64), dim=-1, keepdim=True)
    budget = torch.clamp(cfg.num_features_max - n_live, min=0)
    order = torch.cumsum(to_create.to(torch.int64), dim=-1) - 1
    to_create = to_create & (order < budget)

    slot_of_meas, got = _rank_assign(
        ~fr.active & ~tracked, to_create,
        _arange(M, meas_id).to(dtype).expand(meas_id.shape))
    tgt = torch.where(got, slot_of_meas, NF)
    oh = _onehot_rows(tgt, NF)                                 # (B, M, NF)
    hit = torch.any(oh, dim=-2)
    new_fid = torch.sum(oh * meas_id[..., :, None], dim=-2)
    ohf = oh.to(dtype)
    new_xp = ohf.transpose(-1, -2) @ meas_xp.to(dtype)
    new_depth = (ohf.transpose(-1, -2) @ meas_depth.to(dtype)[..., None])[
        ..., 0]
    # id-derived descriptors (splitmix32 of fid per word), as the reference
    words = ((new_fid & _MASK32)[..., None] * 8 + _arange(8, new_fid)) \
        & _MASK32
    new_desc = _splitmix32(words)
    fr = fr._replace(
        fid=torch.where(hit, new_fid, fr.fid),
        status=torch.where(hit, FS_CREATED, fr.status),
        track=torch.where(hit, TS_CREATED, fr.track),
        ref=torch.where(hit, -1, fr.ref),
        sind=torch.where(hit, -1, fr.sind),
        init_counter=torch.where(hit, 0, fr.init_counter),
        lifetime=torch.where(hit, 0, fr.lifetime),
        outlier_counter=torch.where(hit, 0.0, fr.outlier_counter),
        xp=_where(hit, new_xp, fr.xp),
        tri_ok=fr.tri_ok & ~hit,
        adj=fr.adj & ~hit[..., None],
        sim_depth=torch.where(hit, new_depth, fr.sim_depth),
        desc=_where(hit, new_desc, fr.desc))
    return s._replace(features=fr)


# ---------------------------------------------------------------------------
# UpdateStep phases
# ---------------------------------------------------------------------------

def _process_tracks(cfg: VIOConfig, s: VIOState):
    """ProcessTracks (src/manager.cpp:171-250) in masked form.
    Returns (state, affected_groups (B, NG), OOS candidates over the cap
    (B,))."""
    fr, gr = s.features, s.groups
    NG = gr.gid.shape[-1]
    kind = cam_mod.MODEL_IDS[cfg.cam_model]

    active = fr.active
    instate = fr.sind >= 0
    dropped = active & (fr.track == TS_DROPPED)

    fr = fr._replace(lifetime=torch.where(active, fr.lifetime + 1,
                                          fr.lifetime))
    gr = gr._replace(lifetime=torch.where(gr.active, gr.lifetime + 1,
                                          gr.lifetime))
    s = s._replace(features=fr, groups=gr)

    # 1) instate features dropped by the tracker -> free slot, mark group
    inst_drop = dropped & instate
    affected = torch.any(inst_drop[..., :, None]
                         & _onehot_rows(fr.ref, NG), dim=-2)
    s = _remove_features_from_state(cfg, s, inst_drop)

    # 1b) MSCKF/OOS update: never-instate features leaving the tracker
    # spend their multi-view information before they are destroyed
    n_oos_dropped = torch.zeros_like(s.vision_counter)
    if cfg.use_OOS:
        from .oos import oos_update
        s, n_oos_dropped = oos_update(cfg, s, dropped & ~instate)

    # 2) all dropped rows leave the table
    s = s._replace(features=_clear_feature_rows(s.features, dropped))
    fr = s.features

    # 3) subfilter update for tracked, non-instate features
    sub = fr.active & (fr.track == TS_TRACKED) & (fr.sind < 0) \
        & ((fr.status == FS_INITIALIZING) | (fr.status == FS_READY))
    grow = torch.clamp(fr.ref, 0, NG - 1)
    Rsbr = take_rows(gr.Rsb, grow)
    Tsbr = take_rows(gr.Tsb, grow)
    Xb = bcast_X(s.X)
    intrin = s.cam[:, None]

    # 3a) two-view triangulation on the second observation
    if cfg.triangulate_pre_subfilter:
        first_xp = torch.gather(
            fr.adj_xp, 2, grow[..., None, None].expand(grow.shape + (1, 2))
        )[..., 0, :]
        n_tri = sub & (fr.init_counter == 0)
        xc1 = cam_mod.unproject(kind, intrin, first_xp)
        xc2 = cam_mod.unproject(kind, intrin, fr.xp)
        R1 = Rsbr @ Xb.Rbc
        T1 = (Rsbr @ Xb.Tbc[..., None])[..., 0] + Tsbr
        R2 = Xb.Rsb @ Xb.Rbc
        T2 = (Xb.Rsb @ Xb.Tbc[..., None])[..., 0] + Xb.Tsb
        g12R = R1.transpose(-1, -2) @ R2
        g12T = (R1.transpose(-1, -2) @ (T2 - T1)[..., None])[..., 0]
        Xc1, tri_valid = triangulate_two_view_checked(
            g12R, g12T, xc1, xc2, cfg.triangulation.method,
            cfg.triangulation.max_theta_thresh,
            cfg.triangulation.beta_thresh)
        z = Xc1[..., 2]
        ok = tri_valid & (z > cfg.triangulation.zmin) \
            & (z < cfg.triangulation.zmax)
        zs = torch.where(ok, z, torch.ones_like(z))
        x_tri = torch.where(ok[..., None], torch.stack(
            [Xc1[..., 0] / zs, Xc1[..., 1] / zs, torch.log(zs)], -1), fr.x)
        fr = fr._replace(x=_where(n_tri & ok, x_tri, fr.x),
                         tri_ok=torch.where(n_tri, ok, fr.tri_ok))

    x_new, P_new, out_inc, bad = subfilter_update_table(
        kind, intrin, Xb, Rsbr, Tsbr, fr.x, fr.Psub, fr.xp,
        cfg.subfilter.Rtri, cfg.subfilter.MH_thresh)
    init_c = torch.where(sub, fr.init_counter + 1, fr.init_counter)
    ready = init_c > cfg.subfilter.ready_steps
    fr = fr._replace(
        x=_where(sub, x_new, fr.x),
        Psub=_where(sub, P_new, fr.Psub),
        outlier_counter=torch.where(
            sub, torch.where(bad, fr.outlier_counter + out_inc,
                             torch.zeros_like(out_inc)),
            fr.outlier_counter),
        init_counter=init_c,
        status=torch.where(sub, torch.where(ready, FS_READY,
                                            FS_INITIALIZING), fr.status))

    # 3b) subfilter outlier eviction
    evict = sub & (fr.outlier_counter > cfg.remove_outlier_counter)
    return (s._replace(features=_clear_feature_rows(fr, evict)), affected,
            n_oos_dropped)


def _add_feature_blocks(cfg: VIOConfig, P, fr: FeatureTable, new_slot_mask,
                        row_of_slot):
    """Insert subfilter covariances into newly assigned feature slots
    (FillCovarianceBlock, src/feature.cpp:753-776): zero the slot's rows
    (and, dense, columns), then write Psub on the block diagonal of a
    dense P, or chol(Psub) into the slot's own slack-column band of a
    factor."""
    d = cfg.dims
    F = d.n_features
    P = zero_state_entries(
        P, _feature_keep_vector(cfg, new_slot_mask, P.dtype) > 0)
    blocks = take_rows(fr.Psub.to(P.dtype), torch.clamp(row_of_slot, min=0))
    blocks = blocks * new_slot_mask[..., None, None].to(P.dtype)
    fb = d.feature_begin
    eye = torch.eye(F, dtype=P.dtype, device=P.device)
    if P.shape[-1] == P.shape[-2]:
        BD = torch.einsum("bfij,fg->bfigj", blocks, eye).reshape(
            P.shape[0], 3 * F, 3 * F)
        lower = torch.cat([P[:, fb:, :fb], P[:, fb:, fb:] + BD], dim=-1)
        return torch.cat([P[:, :fb], lower], dim=1)
    Lb = chol3x3(blocks) * new_slot_mask[..., None, None].to(P.dtype)
    BD = torch.einsum("bfij,fg->bfigj", Lb, eye).reshape(
        P.shape[0], 3 * F, 3 * F)
    cb = feature_band(d, 0)
    band = P[:, fb:, cb:cb + 3 * F] + BD
    lower = torch.cat([P[:, fb:, :cb], band, P[:, fb:, cb + 3 * F:]], dim=-1)
    return torch.cat([P[:, :fb], lower], dim=1)


def _refine_candidate_depths(cfg: VIOConfig, s: VIOState) -> VIOState:
    """use_depth_opt: Gauss-Newton refinement of the admission candidates'
    depths over their observations; candidates that fail are destroyed
    (src/manager.cpp:386-404)."""
    from .refine import refine_depth
    fr, gr = s.features, s.groups
    NG = gr.gid.shape[-1]
    grow = torch.clamp(fr.ref, 0, NG - 1)
    obs_mask = fr.adj & ~_onehot_rows(grow, NG) & gr.active[:, None, :]
    do = _candidate_mask(cfg, s) & (torch.sum(obs_mask, dim=-1) >= 1)
    xn, Pn, ok = refine_depth(
        cam_mod.MODEL_IDS[cfg.cam_model], s.cam, s.X, take_rows(gr.Rsb, grow),
        take_rows(gr.Tsb, grow), gr.Rsb, gr.Tsb, obs_mask, fr.adj_xp, fr.x,
        fr.Psub, cfg.refinement)
    good = do & ok
    fr = fr._replace(x=_where(good, xn, fr.x),
                     Psub=_where(good, Pn, fr.Psub))
    return s._replace(features=_clear_feature_rows(fr, do & ~ok))


def _candidate_mask(cfg: VIOConfig, s: VIOState):
    fr = s.features
    strict = (s.vision_counter >= cfg.strict_criteria_timesteps)[:, None]
    status_ok = torch.where(strict, fr.status == FS_READY,
                            (fr.status == FS_READY)
                            | (fr.status == FS_INITIALIZING))
    z = torch.exp(fr.x[..., 2])
    ok = (fr.active & (fr.sind < 0) & (fr.track == TS_TRACKED) & status_ok
          & (fr.outlier_counter < 0.01) & (z > cfg.min_z) & (z < cfg.max_z))
    if cfg.max_depth_var_for_admission != float("inf"):
        ok = ok & (fr.Psub[..., 2, 2] < cfg.max_depth_var_for_admission)
    return ok


def _admission_score(cfg: VIOConfig, fr: FeatureTable):
    """Smaller = better: READY first, then the configured uncertainty
    (Criteria::CandidateComparison, src/options.cpp:35-61)."""
    st = cfg.comparison_score_type
    if st == "DepthUncertainty":
        u = fr.Psub[..., 2, 2]
    else:
        u = torch.linalg.vector_norm(
            torch.diagonal(fr.Psub, dim1=-2, dim2=-1), dim=-1)
        if st == "CovarianceDiagNormPlusOutlierCount":
            u = u + fr.outlier_counter
    return torch.where(fr.status == FS_READY, 0.0, 1e6) + u


def _commit_feature_admissions(cfg: VIOConfig, s: VIOState, slot_of_row,
                               got):
    """Apply a feature-slot assignment: table, f2row, covariance blocks.
    Returns (state, new_slot_mask, row_of_slot)."""
    F = cfg.dims.n_features
    fr = s.features
    tgt_slot = torch.where(got, slot_of_row, F)
    f2row, new_slot_mask, row_of_slot = _place_one_hot(tgt_slot, F, s.f2row)
    fr = fr._replace(
        sind=torch.where(got, slot_of_row, fr.sind),
        status=torch.where(got, FS_INSTATE, fr.status),
        x_fej=_where(got, fr.x, fr.x_fej))
    P = _add_feature_blocks(cfg, s.P, fr, new_slot_mask, row_of_slot)
    return (s._replace(features=fr, f2row=f2row, P=P), new_slot_mask,
            row_of_slot)


def _copy_pose_rows(P, new_slot):
    """Group-slot covariance init (AddGroupToState, src/estimator.cpp:
    786-824): every new slot's six rows copy the (Wsb, Tsb) error rows; on
    a factor the row copy alone realizes the error clone, a dense P then
    copies the columns too."""
    G = new_slot.shape[-1]
    gb, ge = L.GROUP_BEGIN, L.GROUP_BEGIN + 6 * G
    sel = new_slot[..., None].expand(new_slot.shape + (6,)).reshape(
        new_slot.shape[0], 6 * G)
    src = torch.cat([P[:, L.WSB:L.WSB + 3], P[:, L.TSB:L.TSB + 3]], 1)
    grows = torch.where(sel[..., None], src.repeat(1, G, 1), P[:, gb:ge])
    P = torch.cat([P[:, :gb], grows, P[:, ge:]], dim=1)
    if P.shape[-1] != P.shape[-2]:
        return P
    src = torch.cat([P[..., L.WSB:L.WSB + 3], P[..., L.TSB:L.TSB + 3]], -1)
    gcols = torch.where(sel[:, None], src.repeat(1, 1, G), P[..., gb:ge])
    return torch.cat([P[..., :gb], gcols, P[..., ge:]], dim=-1)


def _admit_groups(cfg: VIOConfig, s: VIOState):
    """AddGroupOfFeatures (src/manager.cpp:469-566), single pass: groups
    ranked by candidate count, admitted while group slots and the
    cumulative feature budget allow."""
    d = cfg.dims
    NG, G = d.ng_rows, d.n_groups
    fr, gr = s.features, s.groups

    cand = _candidate_mask(cfg, s) & (fr.status == FS_READY)
    ref_oh = _onehot_rows(fr.ref, NG) & cand[..., None]
    n_cand = torch.sum(ref_oh.to(torch.int64), dim=-2)          # (B, NG)
    free_fslots = torch.sum((s.f2row < 0).to(torch.int64), -1, keepdim=True)
    free_gslots = torch.sum((s.g2row < 0).to(torch.int64), -1, keepdim=True)
    # a group is admissible if it needs a slot, or if it is a pure pose
    # clone graduating to a feature-anchor group: clones already hold a
    # slot and covariance, so admission only commits their cohort (no
    # is_clone bit is set unless the config clones)
    need_slot = gr.active & (gr.sind < 0)
    eligible = gr.active & (need_slot | ((gr.sind >= 0) & gr.is_clone)) \
        & (n_cand >= cfg.num_gauge_xy_features)

    key = torch.where(eligible, -n_cand, 1)
    rank, before = _rank_by_key(torch.ones_like(eligible), key)
    demand = torch.where(eligible, n_cand, 0)
    cum_before = torch.sum(before * demand[..., None, :], dim=-1)
    slot_before = torch.sum(before & (eligible & need_slot)[..., None, :],
                            dim=-1)
    slot_ok = torch.where(need_slot, slot_before < free_gslots, True)
    take = eligible & slot_ok & (rank < cfg.max_group_admissions) \
        & (cum_before < torch.clamp(
            free_fslots - max(cfg.num_gauge_xy_features, 1) + 1, min=0))

    def admit(s: VIOState):
        fr, gr = s.features, s.groups
        gslot_of_row, got_g = _rank_assign(
            s.g2row < 0, take & need_slot, -n_cand.to(s.P.dtype))
        tgt = torch.where(got_g, gslot_of_row, G)
        gr = gr._replace(sind=torch.where(got_g, gslot_of_row, gr.sind),
                         is_clone=gr.is_clone & ~take)
        g2row, new_slot, _ = _place_one_hot(tgt, G, s.g2row)
        s = s._replace(groups=gr, g2row=g2row,
                       P=_copy_pose_rows(s.P, new_slot))
        want = cand & take_rows(take, torch.clamp(fr.ref, 0, NG - 1)) \
            & (fr.ref >= 0)
        slot_of_row, got = _rank_assign(s.f2row < 0, want,
                                        _admission_score(cfg, fr))
        return _commit_feature_admissions(cfg, s, slot_of_row, got)

    s_adm, nsm, ros = admit(s)
    any_take = torch.any(take, dim=-1)
    return (where_state(any_take, s_adm, s), nsm & any_take[:, None],
            torch.where(any_take[:, None], ros, -1))


def _apply_init_correlations(cfg: VIOConfig, s: VIOState, new_slot_mask,
                             row_of_slot) -> VIOState:
    """One correlated-init congruence for all slots admitted this frame
    (both admission passes). The reference skips it under a cond when no
    slot is new; here it always runs, and a sequence with no new slot has
    J = 0 exactly, so its factor gains exactly zero."""
    if not cfg.approximate_init_covariance:
        return s
    from .init_cov import add_init_correlations
    return add_init_correlations(cfg, s, new_slot_mask, row_of_slot)


def _admit_features_within_groups(cfg: VIOConfig, s: VIOState):
    """AddFeaturesWithInGroups (src/manager.cpp:358-405)."""
    fr, gr = s.features, s.groups
    NG = gr.gid.shape[-1]
    cand = _candidate_mask(cfg, s)
    anchor_ok = (gr.sind >= 0) & ~gr.is_clone
    ref_instate = take_rows(anchor_ok, torch.clamp(fr.ref, 0, NG - 1))
    want = cand & ref_instate & (fr.ref >= 0)
    slot_of_row, got = _rank_assign(s.f2row < 0, want,
                                    _admission_score(cfg, fr))
    return _commit_feature_admissions(cfg, s, slot_of_row, got)


def _discard_affected_groups(cfg: VIOConfig, s: VIOState, affected):
    """DiscardAffectedGroups + ownership transfer (src/manager.cpp:310-328,
    src/graph.cpp:174-232). Returns (state, changed (B,))."""
    s_run, changed = _discard_affected_groups_impl(cfg, s, affected)
    run = torch.any(affected, dim=-1)
    return where_state(run, s_run, s), changed & run


def _discard_affected_groups_impl(cfg: VIOConfig, s: VIOState, affected):
    fr, gr = s.features, s.groups
    NG = gr.gid.shape[-1]

    inst_feat = fr.sind >= 0
    n_instate_of = torch.sum((_onehot_rows(fr.ref, NG)
                              & inst_feat[..., None]).to(torch.int64), -2)
    if cfg.num_gauge_xy_features > 0:
        discard = affected & gr.active \
            & (n_instate_of < cfg.num_gauge_xy_features)
    else:
        discard = affected & gr.active & (n_instate_of == 0)

    grow_old = torch.clamp(fr.ref, 0, NG - 1)
    needs = fr.active & take_rows(discard, grow_old) & (fr.ref >= 0)
    ginstate_ok = gr.instate & ~discard
    owner_ok = fr.adj & ginstate_ok[..., None, :]
    has_owner = torch.any(owner_ok, dim=-1)
    new_ref = _first_true(owner_ok)
    grow_new = torch.clamp(new_ref, 0, NG - 1)
    xn, Pn, okz = change_owner(
        bcast_X(s.X), take_rows(gr.Rsb, grow_old),
        take_rows(gr.Tsb, grow_old), take_rows(gr.Rsb, grow_new),
        take_rows(gr.Tsb, grow_new), fr.x, fr.Psub)

    transfer = needs & has_owner & okz
    failed = needs & ~transfer
    fr = fr._replace(
        x=_where(transfer, xn, fr.x),
        Psub=_where(transfer, Pn * cfg.feature_owner_change_cov_factor,
                    fr.Psub),
        ref=torch.where(transfer, new_ref, fr.ref),
        x_fej=_where(transfer, xn, fr.x_fej))
    s = s._replace(features=fr)

    # failed transfers: removed from state and destroyed
    s = _remove_features_from_state(cfg, s, failed)
    s = s._replace(features=_clear_feature_rows(s.features, failed))

    s = _remove_groups_from_state(cfg, s, discard)
    gr = s.groups
    gr = gr._replace(gid=torch.where(discard, -1, gr.gid),
                     lifetime=torch.where(discard, 0, gr.lifetime))
    fr = s.features._replace(adj=s.features.adj & ~discard[..., None, :])
    changed = torch.any(discard, -1) | torch.any(transfer, -1) \
        | torch.any(failed, -1)
    return s._replace(groups=gr, features=fr), changed


def _one_pt_ransac(cfg: VIOConfig, s: VIOState, inlier_slots):
    """Low-innovation partial update and chi-square rescue of the rest
    (Estimator::OnePointRANSAC, src/update.cpp:213-393, whose hypothesis
    loop never applies its hypothesis, so that every iteration's inlier
    set is the same): split the MH inliers into low- and high-innovation
    slots; update a copy of the state with the low ones alone, the
    covariance of the unobservable directions zeroed first; rescue the
    high ones that pass the chi-square gate on that copy. The reference
    runs the partial update under ``lax.cond(any high)``; here it runs for
    every sequence and the rescue is masked where no slot is high, as a
    batch ``vmap`` makes of that cond. Returns (the final inlier slots,
    the rejected slots), each (B, F); the state itself is not changed."""
    d = cfg.dims
    NGR = d.ng_rows
    dtype = s.P.dtype
    fr = s.features
    sj = build_stacked_jacobian(cfg, s)
    res_norm = torch.linalg.vector_norm(
        sj.inn.reshape(sj.valid.shape + (2,)), dim=-1)
    li = inlier_slots & sj.valid & (res_norm < cfg.ransac_thresh)
    hi = inlier_slots & sj.valid & ~li

    # groups owning at least one low-innovation inlier
    li_rows = torch.any(li[..., None] & _onehot_rows(s.f2row, d.nf_rows),
                        dim=-2)
    g_with_li = torch.any((li_rows & (fr.ref >= 0))[..., None]
                          & _onehot_rows(fr.ref, NGR), dim=-2)
    # zero the covariance of the feature slots that are not low-innovation
    # and of the instate groups without such a feature
    keepf = _feature_keep_vector(cfg, (s.f2row >= 0) & ~li, dtype)
    g_noli = (s.g2row >= 0) & ~take_rows(
        g_with_li, torch.clamp(s.g2row, 0, NGR - 1))
    keepg = _group_keep_vector(cfg, g_noli, dtype)
    P_li = zero_state_entries(s.P, (keepf * keepg) > 0)
    diagR = torch.full(sj.inn.shape, cfg.R, dtype=dtype, device=s.P.device)
    err, P_upd = measurement_update(P_li, sj.H, sj.inn, diagR, li)
    s_upd = absorb_error(cfg, s._replace(P=P_upd), err)

    # the high-innovation slots against the updated copy
    sj2 = build_stacked_jacobian(cfg, s_upd)
    dist2 = mh_distances(s_upd.P, sj2.H, sj2.inn, cfg.R)
    any_hi = torch.any(hi, dim=-1, keepdim=True)
    rescued = hi & (dist2 < cfg.ransac_Chi2)
    final = torch.where(any_hi, li | rescued, inlier_slots)
    return final, inlier_slots & sj.valid & ~final


def _destroy_slots(cfg: VIOConfig, s: VIOState, slots):
    """Remove the features of the masked EKF slots (B, F) from the state
    and the table; returns (state, their groups (B, NG))."""
    d = cfg.dims
    rows_idx = torch.where(slots, s.f2row, -1)
    rows = torch.any((rows_idx >= 0)[..., None]
                     & _onehot_rows(rows_idx, d.nf_rows), dim=-2)
    affected = torch.any((rows & (s.features.ref >= 0))[..., None]
                         & _onehot_rows(s.features.ref, d.ng_rows), dim=-2)
    s = _remove_features_from_state(cfg, s, rows)
    return s._replace(features=_clear_feature_rows(s.features, rows)), \
        affected


def _refresh_gauge_features(cfg: VIOConfig, s: VIOState) -> VIOState:
    """Keep every instate group at num_gauge_xy gauge features
    (FindNewGaugeFeatures, src/graph.cpp:271-360; FixFeatureXY)."""
    if cfg.num_gauge_xy_features == 0:
        return s
    fr, gr = s.features, s.groups
    NG = gr.gid.shape[-1]
    NF = fr.fid.shape[-1]
    F = cfg.dims.n_features
    is_gauge = fr.active & (fr.status == FS_GAUGE) & (fr.sind >= 0)
    n_gauge = torch.sum((_onehot_rows(fr.ref, NG)
                         & is_gauge[..., None]).to(torch.int64), -2)
    deficit = torch.where(gr.instate & ~gr.is_clone,
                          cfg.num_gauge_xy_features - n_gauge, 0)

    cand = fr.active & (fr.status == FS_INSTATE) & (fr.sind >= 0) \
        & (fr.ref >= 0)
    lower = torch.tril(torch.ones((NF, NF), dtype=torch.bool,
                                  device=cand.device), diagonal=-1)
    same = fr.ref[..., :, None] == fr.ref[..., None, :]
    rank = torch.sum(lower & same & cand[..., None, :] & cand[..., :, None],
                     dim=-1)
    promote = cand & (rank < take_rows(deficit,
                                       torch.clamp(fr.ref, 0, NG - 1)))
    fr_run = fr._replace(status=torch.where(promote, FS_GAUGE, fr.status))
    hitslot = _slot_mask_of_rows(promote, fr.sind, F)
    xy = constant((True, True, False), torch.bool, hitslot.device)
    mask2 = (hitslot[..., None] & xy).reshape(hitslot.shape[0], 3 * F)
    keep = torch.cat([torch.ones((mask2.shape[0], cfg.dims.feature_begin),
                                 dtype=torch.bool, device=mask2.device),
                      ~mask2], dim=1)
    s_run = s._replace(features=fr_run, P=zero_state_entries(s.P, keep))
    need = torch.any((deficit > 0) & gr.instate, dim=-1)
    return where_state(need, s_run, s)


def _switch_gauge_group(cfg: VIOConfig, s: VIOState) -> VIOState:
    """SwitchRefGroup (src/estimator.cpp:1362-1391): when the gauge group
    is lost, freeze 4 or 6 dof of the instate group with the smallest
    pose covariance."""
    gr = s.groups
    G = cfg.dims.n_groups
    diag = cov_diag(s.P)
    tr6 = diag[:, L.GROUP_BEGIN:L.GROUP_BEGIN + 6 * G].reshape(-1, G, 6) \
        .sum(-1)
    tr = take_rows(tr6, torch.clamp(gr.sind, 0, G - 1))
    tr = torch.where(gr.instate, tr, torch.inf)
    row = _first_true(tr == tr.min(dim=-1, keepdim=True).values)
    gslot = take_rows(gr.sind, row[:, None])[:, 0]
    off = L.GROUP_BEGIN + 6 * gslot
    start = off + 2 if cfg.group_degrees_fixed == 4 else off
    n_fix = cfg.group_degrees_fixed
    entry = _arange(cfg.dims.full, start)
    keep = ~((entry >= start[:, None]) & (entry < start[:, None] + n_fix))
    s_pick = s._replace(P=zero_state_entries(s.P, keep), gauge_row=row)
    do = (s.gauge_row < 0) & torch.any(gr.instate, dim=-1)
    return where_state(do, s_pick, s)


def _enforce_max_group_lifetime(cfg: VIOConfig, s: VIOState) -> VIOState:
    """EnforceMaxGroupLifetime (src/manager.cpp:282-306)."""
    fr, gr = s.features, s.groups
    NG = gr.gid.shape[-1]
    is_ref = torch.any((fr.active & (fr.ref >= 0))[..., None]
                       & _onehot_rows(fr.ref, NG), dim=-2)
    old = gr.active & (gr.lifetime > cfg.max_group_lifetime) & ~is_ref \
        & ~gr.instate
    gr = gr._replace(gid=torch.where(old, -1, gr.gid),
                     lifetime=torch.where(old, 0, gr.lifetime))
    fr = fr._replace(adj=fr.adj & ~old[..., None, :])
    return s._replace(features=fr, groups=gr)


def _create_group_and_init_tracks(cfg: VIOConfig, s: VIOState) -> VIOState:
    """End-of-frame group creation + new-track initialization
    (Group::Create + InitializeJustCreatedTracks, src/manager.cpp:119-128,
    570-627). Row policy: a free row, else the oldest non-instate row
    nobody references, else force-evict the oldest non-instate row and
    drop the features anchored to it."""
    fr, gr = s.features, s.groups
    NG = gr.gid.shape[-1]
    kind = cam_mod.MODEL_IDS[cfg.cam_model]
    dtype = s.P.dtype

    free = ~gr.active
    is_ref = torch.any((fr.active & (fr.ref >= 0))[..., None]
                       & _onehot_rows(fr.ref, NG), dim=-2)
    evictable = gr.active & ~gr.instate & ~is_ref
    forceable = gr.active & ~gr.instate
    pick_free = torch.any(free, dim=-1)
    pick_evict = torch.any(evictable, dim=-1)
    neg = torch.full_like(gr.lifetime, -1)
    row = torch.where(
        pick_free, _first_true(free),
        torch.where(pick_evict,
                    torch.argmax(torch.where(evictable, gr.lifetime, neg), -1),
                    torch.argmax(torch.where(forceable, gr.lifetime, neg),
                                 -1)))

    forced = ~pick_free & ~pick_evict
    orphans = fr.active & (fr.ref == row[:, None]) & forced[:, None]
    s = _remove_features_from_state(cfg, s, orphans)
    fr = _clear_feature_rows(s.features, orphans)
    gr = s.groups

    X = s.X
    gr = gr._replace(
        gid=_set_row(gr.gid, row, s.next_gid),
        Rsb=_set_row(gr.Rsb, row, X.Rsb),
        Tsb=_set_row(gr.Tsb, row, X.Tsb),
        lifetime=_set_row(gr.lifetime, row, torch.zeros_like(row)),
        sind=_set_row(gr.sind, row, torch.full_like(row, -1)),
        is_clone=_set_row(gr.is_clone, row, torch.zeros_like(pick_free)),
        Rsb_fej=_set_row(gr.Rsb_fej, row, X.Rsb),
        Tsb_fej=_set_row(gr.Tsb_fej, row, X.Tsb))
    row_col = _onehot_rows(row[:, None], NG)                   # (B, 1, NG)
    fr = fr._replace(adj=fr.adj & ~row_col)
    s = s._replace(gauge_row=torch.where(row == s.gauge_row, -1,
                                         s.gauge_row))

    # new tracks: ref = the new group, local state initialized
    newf = fr.active & (fr.track == TS_CREATED)
    xc = cam_mod.unproject(kind, s.cam[:, None], fr.xp)
    fx = s.cam[:, :1]
    use_sim = cfg.sim_initialize_depths & (fr.sim_depth > 0)
    z0 = torch.where(use_sim, fr.sim_depth, s.init_z[:, None])
    x_init = torch.cat([xc, torch.log(z0)[..., None]], dim=-1)
    if cfg.triangulate_pre_subfilter:
        sx, sy, sz = (cfg.init_std_x_badtri, cfg.init_std_y_badtri,
                      cfg.init_std_z_badtri)
    else:
        sx, sy, sz = cfg.init_std_x, cfg.init_std_y, cfg.init_std_z
    ones = torch.ones_like(fr.sim_depth)
    stds = torch.stack([ones * sx / fx, ones * sy / fx, ones * sz], dim=-1)
    P_init = torch.diag_embed(stds ** 2)
    fr = fr._replace(
        ref=torch.where(newf, row[:, None], fr.ref),
        x=_where(newf, x_init.to(dtype), fr.x),
        Psub=_where(newf, P_init, fr.Psub),
        status=torch.where(newf, FS_INITIALIZING, fr.status))

    # every live track observes the new group at its current pixel
    obs = fr.active & ((fr.track == TS_TRACKED) | newf)
    fr = fr._replace(
        adj=torch.where(row_col, obs[..., None], fr.adj),
        adj_xp=torch.where(row_col[..., None], fr.xp[..., None, :],
                           fr.adj_xp))
    s = s._replace(features=fr, groups=gr, next_gid=s.next_gid + 1)
    if cfg.use_OOS or cfg.clone_frame_groups:
        s = _clone_group_into_state(cfg, s, row)
    return s


def _clone_group_into_state(cfg: VIOConfig, s: VIOState, row) -> VIOState:
    """MSCKF-style pose cloning: the frame's new group (row (B,)) joins
    the EKF window without admitted features, so that never-instate
    features see a sliding window of recent poses. When the window is
    full the oldest instate group anchoring no instate feature (a pure
    clone) is marginalized. The reference evicts under a cond; here the
    eviction runs on every sequence with a row mask that is empty where
    nothing is evicted, which leaves that sequence's state exactly as it
    was (its factor rows are multiplied by 1)."""
    gr, fr = s.groups, s.features
    G = cfg.dims.n_groups
    NG = gr.gid.shape[-1]

    grow_of_slot = torch.clamp(s.g2row, 0, NG - 1)
    anchors = torch.any((fr.sind >= 0)[..., None] & _onehot_rows(fr.ref, NG),
                        dim=-2)                                # (B, NG)
    occupied = s.g2row >= 0
    evictable = occupied & ~take_rows(anchors, grow_of_slot)
    slot_gid = take_rows(gr.gid, grow_of_slot)
    evict_slot = torch.argmin(torch.where(evictable, slot_gid, 2 ** 31 - 1),
                              dim=-1)
    need_evict = torch.all(occupied, -1) & torch.any(evictable, -1)
    evict_row = torch.where(
        need_evict, take_rows(grow_of_slot, evict_slot[:, None])[:, 0], NG)
    s = _remove_groups_from_state(cfg, s, _onehot_rows(evict_row[:, None],
                                                       NG)[:, 0])

    # a free slot, if any, takes the new row; its covariance rows copy
    # the body pose's
    free = s.g2row < 0
    can = torch.any(free, dim=-1)
    slot = _first_true(free)
    at_row = _onehot_rows(row[:, None], NG)[:, 0] & can[:, None]
    new_slot = _onehot_rows(slot[:, None], G)[:, 0] & can[:, None]
    gr = s.groups._replace(
        sind=torch.where(at_row, slot[:, None], s.groups.sind),
        is_clone=s.groups.is_clone | at_row)
    return s._replace(groups=gr,
                      g2row=torch.where(new_slot, row[:, None], s.g2row),
                      P=_copy_pose_rows(s.P, new_slot))


def _adapt_initial_depth(cfg: VIOConfig, s: VIOState) -> VIOState:
    """AdaptInitialDepth (src/manager.cpp:255-278): EMA of median depth."""
    fr = s.features
    use = fr.active & ((fr.sind >= 0)
                       | ((fr.status == FS_READY)
                          & (fr.lifetime > cfg.adaptive_depth_min_lifetime)))
    z = torch.exp(fr.x[..., 2])
    n = torch.sum(use.to(torch.int64), dim=-1)
    zs = torch.sort(torch.where(use, z, torch.inf), dim=-1).values
    med = take_rows(zs[..., None], torch.clamp(n // 2, 0, z.shape[-1] - 1)
                    [:, None])[:, 0, 0]
    ok = (n > 0) & (med > cfg.min_z) & (med < cfg.max_z)
    beta = cfg.adaptive_depth_beta
    new_z = torch.where(ok, (1.0 - beta) * s.init_z + beta * med, s.init_z)
    return s._replace(init_z=new_z.to(s.init_z.dtype))


# ---------------------------------------------------------------------------
# the frame step
# ---------------------------------------------------------------------------

class StepOutputs(NamedTuple):
    Rsb: torch.Tensor
    Tsb: torch.Tensor
    Vsb: torch.Tensor
    num_instate_features: torch.Tensor
    num_instate_groups: torch.Tensor
    num_tracked: torch.Tensor
    num_mh_rejected: torch.Tensor
    num_oneptransac_rejected: torch.Tensor
    num_tracker_outlier_rejected: torch.Tensor
    inn_rms: torch.Tensor
    num_oos_dropped: torch.Tensor


def _count(mask):
    return torch.sum(mask.to(torch.int64), dim=-1)


@tracing.span(tracing.UPDATE)
def update_step(cfg: VIOConfig, s: VIOState) -> Tuple[VIOState, StepOutputs]:
    """The per-frame filter pipeline after tracker association
    (Estimator::UpdateStep, src/manager.cpp:18-167)."""
    d = cfg.dims
    with tracing.span(tracing.TRACKS):
        s, affected, n_oos_dropped = _process_tracks(cfg, s)

    # admission, then ONE correlated-init pass over the union of both
    # admission cohorts
    with tracing.span(tracing.ADMISSION):
        if cfg.use_depth_opt:
            s = _refine_candidate_depths(cfg, s)
        if cfg.num_gauge_xy_features > 0:
            s, nsm_g, ros_g = _admit_groups(cfg, s)
        else:
            nsm_g = torch.zeros_like(s.f2row, dtype=torch.bool)
            ros_g = torch.full_like(s.f2row, -1)
        s, nsm_w, ros_w = _admit_features_within_groups(cfg, s)
        s = _apply_init_correlations(cfg, s, nsm_g | nsm_w,
                                     torch.where(nsm_g, ros_g, ros_w))

    # jacobians + MH gating
    with tracing.span(tracing.GATING):
        sj = build_stacked_jacobian(cfg, s)
        dist = mh_distances(s.P, sj.H, sj.inn, cfg.R)
        n_inst = _count(sj.valid)
        if cfg.use_MH_gating:
            inlier_slots = torch.where((n_inst > cfg.min_inliers)[:, None],
                                       mh_gate(cfg, dist, sj.valid),
                                       sj.valid)
        else:
            inlier_slots = sj.valid
        rejected_slots = sj.valid & ~inlier_slots
        num_rej = _count(rejected_slots)

    with tracing.span(tracing.HYGIENE):
        # rejected features: destroy + mark their groups affected
        s, rej_groups = _destroy_slots(cfg, s, rejected_slots)

        # group hygiene + gauge maintenance
        s, structure_changed = _discard_affected_groups(
            cfg, s, affected | rej_groups)
        s = _refresh_gauge_features(cfg, s)

        num_1pt = torch.zeros_like(num_rej)
        if cfg.use_1pt_RANSAC:
            inlier_slots, ransac_rej = _one_pt_ransac(cfg, s, inlier_slots)
            num_1pt = _count(ransac_rej)
            s, affected2 = _destroy_slots(cfg, s, ransac_rej)
            s, changed2 = _discard_affected_groups(cfg, s, affected2)
            structure_changed = structure_changed | changed2
            s = _refresh_gauge_features(cfg, s)

    # the EKF update with the surviving inliers; ownership transfers
    # invalidate the gating-time Jacobians, so rebuild on those frames
    with tracing.span(tracing.EKF_UPDATE):
        if cfg.recompute_stale_jacobians:
            sj2 = where_state(structure_changed,
                              build_stacked_jacobian(cfg, s), sj)
        else:
            sj2 = sj._replace(valid=sj.valid & (s.f2row >= 0))
        inlier_now = sj2.valid & inlier_slots
        if cfg.use_huber:
            diagR = huber_robustify_R(sj2.inn, cfg.R, cfg.outlier_thresh,
                                      s.P.dtype)
        else:
            diagR = torch.full(sj2.inn.shape, cfg.R, dtype=s.P.dtype,
                               device=s.P.device)
        err, P = measurement_update(s.P, sj2.H, sj2.inn, diagR, inlier_now)
        do_upd = torch.any(inlier_now, dim=-1)
        err = torch.where(do_upd[:, None], err, 0.0)
        P = where_state(do_upd, P, s.P)
        s = absorb_error(cfg, s._replace(P=P), err)

    with tracing.span(tracing.BOOKKEEPING):
        # record predicted pixels (Feature::Predict bookkeeping)
        fr = s.features
        tgt_rows = torch.where(sj2.valid, s.f2row, d.nf_rows)
        oh_pred = _onehot_rows(tgt_rows, d.nf_rows)            # (B, F, NF)
        hit_pred = torch.any(oh_pred, dim=-2)
        new_pred = oh_pred.to(fr.pred.dtype).transpose(-1, -2) \
            @ sj2.pred.to(fr.pred.dtype)
        s = s._replace(features=fr._replace(
            pred=_where(hit_pred, new_pred, fr.pred)))

        # post-update bookkeeping
        s = _create_group_and_init_tracks(cfg, s)
        s = _adapt_initial_depth(cfg, s)
        s = _enforce_max_group_lifetime(cfg, s)
        s = _switch_gauge_group(cfg, s)
        s = s._replace(vision_counter=s.vision_counter + 1)

        inn_masked = sj2.inn.reshape(inlier_now.shape + (2,)) \
            * inlier_now[..., None]
        inn_rms = torch.sqrt(torch.sum(inn_masked ** 2, dim=(-2, -1))
                             / torch.clamp(2 * _count(inlier_now), min=1))
        out = StepOutputs(
            Rsb=s.X.Rsb, Tsb=s.X.Tsb, Vsb=s.X.Vsb,
            num_instate_features=_count(s.f2row >= 0),
            num_instate_groups=_count(s.g2row >= 0),
            num_tracked=_count(s.features.track == TS_TRACKED),
            num_mh_rejected=num_rej,
            num_oneptransac_rejected=num_1pt,
            num_tracker_outlier_rejected=s.n_tracker_rejected,
            inn_rms=inn_rms,
            num_oos_dropped=n_oos_dropped)
    return s, out


def _propagate_frame_fast(cfg: VIOConfig, s: VIOState, imu_gyro, imu_accel,
                          imu_dt, dt_eff) -> VIOState:
    """Fast-mode frame propagation: compose per-IMU-sample transitions
    (the static substep grid, ``ops/imu_chain``: on the card one kernel
    launch; or at ``fast_substeps=0`` the capped loop), then apply them to
    P once: to the factor, absorbing the frame's process noise in the one
    per-frame re-compression, or to the dense motion rows and columns."""
    m = L.MOTION
    dtype = s.P.dtype
    args = (cfg, s.X, s.last_gyro, s.last_accel, s.slope_gyro,
            s.slope_accel, imu_gyro, imu_accel, imu_dt, dt_eff)
    if cfg.fast_substeps > 0:
        X, Phi, Q, lg, la, sg, sa, nprop = imu_chain(*args)
    else:
        X, Phi, Q, lg, la, sg, sa, nprop = chain_plain(
            *args, interval=propagate_interval_fast)
    if cfg.use_oc:
        with tracing.span(tracing.VISUAL_SEGMENT):
            Phi = oc_correct_phi(cfg, Phi, X, s.oc_R, s.oc_V, s.oc_T,
                                 s.X.Rsg)
        s = s._replace(oc_R=X.Rsb, oc_V=X.Vsb, oc_T=X.Tsb)

    with tracing.span(tracing.COV_PROPAGATE):
        Qd = Q + nprop.to(dtype)[:, None, None] \
            * torch.diag(qmodel_diag(cfg, dtype, s.P.device))
        if is_sqrt(cfg):
            P = factor_propagate_absorb(cfg, s.P, Phi, Qd)
        else:
            Pmm = Phi @ s.P[:, :m, :m] @ Phi.transpose(-1, -2) + Qd
            P = with_motion_block(s.P, 0.5 * (Pmm + Pmm.transpose(-1, -2)),
                                  Phi @ s.P[:, :m, m:])
    if cfg.fast_substeps > 0:
        # the grid's substeps skip the polar projection; restore
        # orthonormality once a frame
        X = X._replace(Rsb=so3.project(X.Rsb))
    return s._replace(X=X, P=P, last_gyro=lg, last_accel=la,
                      slope_gyro=sg, slope_accel=sa)


@tracing.span(tracing.PROPAGATE)
def propagate_frame(cfg: VIOConfig, s: VIOState, imu_gyro, imu_accel,
                    imu_dt, frame_dt) -> VIOState:
    """Frame-interval propagation: the IMU samples, then extrapolation to
    the frame time, dispatched on cfg.propagation_mode as the reference
    does. "batched": ``propagate_batched``; "fast":
    ``_propagate_frame_fast``; "reference": one
    ``imu_sample_update`` per IMU slot, then ``propagate_state`` over the
    visual segment. imu_* are (B, KI, ...), frame_dt (B,). Rows with
    dt <= 0 (packing padding) leave the state untouched."""
    if cfg.online_temporal_calib:
        dt_eff = torch.clamp(frame_dt + s.X.td - s.td_applied, min=0.0)
        s = s._replace(td_applied=s.X.td.to(s.td_applied.dtype))
    else:
        dt_eff = frame_dt
    if cfg.propagation_mode == "batched":
        from .propagate_batched import propagate_frame_batched
        return propagate_frame_batched(cfg, s, imu_gyro, imu_accel, imu_dt,
                                       dt_eff)
    if cfg.propagation_mode == "fast":
        return _propagate_frame_fast(cfg, s, imu_gyro, imu_accel, imu_dt,
                                     dt_eff)
    for k in range(imu_dt.shape[1]):
        s = imu_sample_update(cfg, s, imu_gyro[:, k], imu_accel[:, k],
                              imu_dt[:, k])
    return where_state(dt_eff > 0, propagate_state(cfg, s, dt_eff), s)


def vio_frame(cfg: VIOConfig, s: VIOState, imu_gyro, imu_accel, imu_dt,
              frame_dt, meas_id, meas_xp, meas_depth, meas_valid,
              hom_uniforms=None):
    """One full visual frame for B sequences: IMU propagation to frame time
    + tracker + update step. `hom_uniforms` (B, N_HYPS, NF): the frame's
    homography draws, needed with ``cfg.do_outlier_rejection`` only.
    Returns (state, StepOutputs)."""
    check_supported(cfg)
    s = propagate_frame(cfg, s, imu_gyro, imu_accel, imu_dt, frame_dt)
    s = tracker_pointcloud(cfg, s, meas_id, meas_xp, meas_depth, meas_valid,
                           hom_uniforms)
    return update_step(cfg, s)
