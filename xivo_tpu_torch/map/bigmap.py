"""Map-scale mapping: observation retention + BA over the map (port of
``xivo_tpu/map/bigmap.py``).

Each retired landmark keeps up to O normalized-plane observations with
the keyframe slots they were made from, so ``refine_map`` can bundle-adjust
the map (the reference's g2o vertices on retirement,
src/optimizer_adapters.cpp:10-54, with a Solve that is actually run). The
tables carry a leading batch axis B; ``init_bigmap`` builds one
sequence's. Keyframe slots are a ring like the landmarks.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .. import resolve_device
from ..ba.core import BAProblem, solve as ba_solve
from ..cam import models as cam_mod
from ..filter.config import VIOConfig
from ..filter.features import unproject_logz
from ..filter.state import VIOState
from ..ops.dense import take_rows
from .mapper import MapState, _scatter_rows


class BigMapState(NamedTuple):
    # landmark tables
    Xs: torch.Tensor        # (B,M,3)
    desc: torch.Tensor      # (B,M,8) 32-bit descriptor words in int64
    valid: torch.Tensor     # (B,M)
    obs_xn: torch.Tensor    # (B,M,O,2) normalized-plane observations
    obs_kf: torch.Tensor    # (B,M,O) int64 keyframe slot, -1 invalid
    epoch: torch.Tensor     # (B,M) vision_counter at insertion
    write_ptr: torch.Tensor
    count: torch.Tensor
    # keyframe ring (camera-to-world poses)
    kf_R: torch.Tensor      # (B,Kc,3,3)
    kf_T: torch.Tensor      # (B,Kc,3)
    kf_valid: torch.Tensor  # (B,Kc)
    kf_ptr: torch.Tensor
    # group-table row -> keyframe slot, validated by gid
    kf_of_grow: torch.Tensor  # (B,NGR)
    kf_gid: torch.Tensor      # (B,NGR) gid the mapping was made for


def init_bigmap(cfg: VIOConfig, capacity: int = 4096, obs_cap: int = 8,
                kf_capacity: int = 256, dtype=torch.float32,
                device="cuda") -> BigMapState:
    """An empty map of ONE sequence (no batch axis)."""
    dev = resolve_device(device)
    NGR = cfg.dims.ng_rows
    i64 = dict(dtype=torch.int64, device=dev)
    fd = dict(dtype=dtype, device=dev)
    zero = torch.zeros((), **i64)
    return BigMapState(
        Xs=torch.zeros((capacity, 3), **fd),
        desc=torch.zeros((capacity, 8), **i64),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=dev),
        obs_xn=torch.zeros((capacity, obs_cap, 2), **fd),
        obs_kf=torch.full((capacity, obs_cap), -1, **i64),
        epoch=torch.zeros((capacity,), **i64),
        write_ptr=zero, count=zero.clone(),
        kf_R=torch.eye(3, **fd).repeat(kf_capacity, 1, 1),
        kf_T=torch.zeros((kf_capacity, 3), **fd),
        kf_valid=torch.zeros((kf_capacity,), dtype=torch.bool, device=dev),
        kf_ptr=zero.clone(),
        kf_of_grow=torch.full((NGR,), -1, **i64),
        kf_gid=torch.full((NGR,), -1, **i64))


def retire_features_obs(cfg: VIOConfig, s: VIOState, bm: BigMapState,
                        row_mask) -> BigMapState:
    """Retire feature rows (mask (B, NF)) WITH their observation history:
    keyframe slots for every group they observed (dedup'd by the
    gid-validated row mapping), up to O (keyframe, normalized observation)
    pairs per feature, then a ring insert of landmarks and rows."""
    fr, gr = s.features, s.groups
    NGR = gr.gid.shape[-1]
    O = bm.obs_kf.shape[-1]
    Kc = bm.kf_R.shape[1]
    M = bm.Xs.shape[1]
    dtype = bm.Xs.dtype
    kind = cam_mod.MODEL_IDS[cfg.cam_model]

    retire = row_mask & fr.active & (fr.ref >= 0)

    # 1. keyframes
    mapping_ok = (bm.kf_of_grow >= 0) & (bm.kf_gid == gr.gid)
    obs_groups = torch.any(fr.adj & retire[..., None], dim=-2) & gr.active
    need = obs_groups & ~mapping_ok
    rank = torch.cumsum(need.to(torch.int64), -1) - 1
    new_slot = (bm.kf_ptr[:, None] + rank) % Kc
    tgt = torch.where(need, new_slot, Kc)
    Rsc = (gr.Rsb @ s.X.Rbc[:, None]).to(dtype)
    Tsc = ((gr.Rsb @ s.X.Tbc[:, None, :, None])[..., 0] + gr.Tsb).to(dtype)
    kf_of_grow = torch.where(need, new_slot,
                             torch.where(mapping_ok, bm.kf_of_grow, -1))
    bm = bm._replace(
        kf_R=_scatter_rows(bm.kf_R, tgt, Rsc),
        kf_T=_scatter_rows(bm.kf_T, tgt, Tsc),
        kf_valid=_scatter_rows(bm.kf_valid, tgt, torch.ones_like(need)),
        kf_of_grow=kf_of_grow,
        kf_gid=torch.where(need | mapping_ok, gr.gid, -1),
        kf_ptr=(bm.kf_ptr + torch.sum(need.to(torch.int64), -1)) % Kc)

    # 2. per feature, its first O observed group rows (a stable sort puts
    # the observed rows first, in row order)
    order = torch.argsort((~fr.adj).to(torch.int64), dim=-1,
                          stable=True)[..., :O]                  # (B,NF,O)
    kf_rows = torch.gather(kf_of_grow[:, None].expand(fr.adj.shape), -1,
                           order)
    got = torch.gather(fr.adj, -1, order) & (kf_rows >= 0)
    obs_kf = torch.where(got, kf_rows, -1)
    xp = torch.gather(fr.adj_xp, 2,
                      order[..., None].expand(order.shape + (2,)))
    obs_xn = cam_mod.unproject(kind, s.cam[:, None, None], xp).to(dtype)

    # 3. landmark positions + ring insert
    grow = torch.clamp(fr.ref, 0, NGR - 1)
    Xc, _ = unproject_logz(fr.x)
    R = take_rows(gr.Rsb, grow)
    T = take_rows(gr.Tsb, grow)
    Xs = (R @ ((s.X.Rbc[:, None] @ Xc[..., None])[..., 0]
               + s.X.Tbc[:, None])[..., None])[..., 0] + T
    n_ret = torch.sum(retire.to(torch.int64), -1)
    lrank = torch.cumsum(retire.to(torch.int64), -1) - 1
    ltgt = torch.where(retire, (bm.write_ptr[:, None] + lrank) % M, M)
    return bm._replace(
        Xs=_scatter_rows(bm.Xs, ltgt, Xs),
        desc=_scatter_rows(bm.desc, ltgt, fr.desc),
        valid=_scatter_rows(bm.valid, ltgt, torch.ones_like(retire)),
        obs_xn=_scatter_rows(bm.obs_xn, ltgt, obs_xn),
        obs_kf=_scatter_rows(bm.obs_kf, ltgt, obs_kf),
        epoch=_scatter_rows(bm.epoch, ltgt,
                            s.vision_counter[:, None].expand_as(ltgt)),
        write_ptr=(bm.write_ptr + n_ret) % M,
        count=bm.count + n_ret)


def map_ba_problem(bm: BigMapState, min_obs: int = 2) -> BAProblem:
    """The BA problem of the map's tables: a dense (M, Kc) mask and
    observations, landmarks with at least min_obs observations; gauge: the
    two oldest valid keyframe slots are fixed."""
    Kc = bm.kf_R.shape[1]
    dtype = bm.Xs.dtype
    oh = bm.obs_kf[..., None] == torch.arange(Kc, device=bm.Xs.device)
    mask = torch.any(oh, dim=-2)                             # (B,M,Kc)
    obs = torch.einsum("blok,bloc->blkc", oh.to(dtype), bm.obs_xn)
    n_obs = torch.sum(mask.to(torch.int64), -1)
    lm_ok = bm.valid & (n_obs >= min_obs)
    mask = mask & lm_ok[..., None] & bm.kf_valid[:, None, :]
    fixed = bm.kf_valid & (torch.cumsum(bm.kf_valid.to(torch.int64), -1) <= 2)
    return BAProblem(Rs=bm.kf_R, Ts=bm.kf_T, Xs=bm.Xs, obs=obs, mask=mask,
                     fixed=fixed)


def refine_map(cfg: VIOConfig, bm: BigMapState, iters: int = 10,
               damping: float = 1e-4, huber_thresh: float = 0.01,
               mesh=None, min_obs: int = 2
               ) -> Tuple[BigMapState, torch.Tensor]:
    """BA refinement job over the retained map. Returns (refined map, chi2
    history (B, iters)). With ``mesh``, a ``torch.distributed`` group,
    the map's landmarks are split over its ranks (``dist/ba.py``; the
    capacity must divide by the ranks), and every rank returns the whole
    refined map."""
    p = map_ba_problem(bm, min_obs=min_obs)
    if mesh is None:
        p2, chi2 = ba_solve(p, iters=iters, damping=damping,
                            huber_thresh=huber_thresh)
    else:
        from ..dist.ba import make_distributed_solver, shard_problem
        from ..dist.multihost import all_gather_dim
        p2, chi2 = make_distributed_solver(
            mesh, iters=iters, damping=damping, huber_thresh=huber_thresh)(
                shard_problem(p, mesh))
        p2 = p2._replace(Xs=all_gather_dim(p2.Xs, 1, mesh))
    moved = torch.any(p.mask, dim=-1)
    return bm._replace(
        Xs=torch.where(moved[..., None], p2.Xs, bm.Xs),
        kf_R=torch.where(bm.kf_valid[..., None, None], p2.Rs, bm.kf_R),
        kf_T=torch.where(bm.kf_valid[..., None], p2.Ts, bm.kf_T)), chi2


def as_mapstate(bm: BigMapState) -> MapState:
    """The landmark tables as a plain MapState for the loop-closure path;
    BA-refined landmarks carry no covariance table, so a small isotropic
    prior keeps the closure rows' R inflation well-defined."""
    B, M = bm.valid.shape
    dt, dev = bm.Xs.dtype, bm.Xs.device
    return MapState(
        Xs=bm.Xs, desc=bm.desc, valid=bm.valid, epoch=bm.epoch,
        cov=(0.01 * torch.eye(3, dtype=dt, device=dev)).expand(
            B, M, 3, 3).clone(),
        gid=torch.full((B, M), -1, dtype=torch.int64, device=dev),
        write_ptr=bm.write_ptr, count=bm.count,
        n_merged=torch.zeros_like(bm.count))
