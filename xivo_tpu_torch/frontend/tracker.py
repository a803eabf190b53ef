"""Image tracker: LK tracking + FAST detection over the filter's tables
(port of ``xivo_tpu/frontend/tracker.py``).

Port of Tracker::UpdateLK / DetectLK (src/tracker.cpp:463-629, 219-329)
onto the masked FeatureTable, plus ``vio_frame_image``: the image-mode
analogue of the point-cloud ``vio_frame``, one call per camera frame for
B sequences (IMU propagation, LK, masked detection, BRIEF extraction and
the filter update step). Every tensor carries the batch axis B first;
nothing in a frame reads a value back to the host.

Not ported yet (ROADMAP A.12): the MATCH tracker (``tracker_match``),
homography outlier rejection, detectors other than FAST and descriptors
other than BRIEF (so the reference's detector and descriptor factories
reduce to ``fast_score`` and ``brief.extract``);
``filter.state.check_supported`` refuses a config that asks for them.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .. import resolve_device
from ..cam import models as cam_mod
from ..filter.config import VIOConfig
from ..filter.features import bcast_X, predict_pixel
from ..filter.pipeline import (_clear_feature_rows, _rank_assign, _where,
                               propagate_frame, update_step)
from ..filter.state import (FS_CREATED, TS_CREATED, TS_DROPPED, TS_TRACKED,
                            VIOState, check_supported)
from ..ops.dense import take_rows
from . import brief
from .fast import fast_score, nms3, select_topk
from .image import blur5, build_pyramid
from .lk import track

K_DET = 64   # static per-frame detection budget (the reference's)


class FrontendState(NamedTuple):
    """Image state carried between frames (the previous pyramid)."""
    pyr: Tuple[torch.Tensor, ...]   # (B, h, w) float32 per level
    initialized: torch.Tensor       # (B,) bool


def init_frontend(cfg: VIOConfig, device="cuda") -> FrontendState:
    """Initial front-end state of ONE sequence (no batch axis);
    ``runner.batch_frontend_states`` stacks B of these."""
    dev = resolve_device(device)
    rows, cols = int(cfg.cam_params[0]), int(cfg.cam_params[1])
    pyr = []
    h, w = rows, cols
    for _ in range(cfg.klt_max_level):
        pyr.append(torch.zeros((h, w), dtype=torch.float32, device=dev))
        h, w = (h + 1) // 2, (w + 1) // 2
    return FrontendState(pyr=tuple(pyr), initialized=torch.zeros(
        (), dtype=torch.bool, device=dev))


def tracker_image(cfg: VIOConfig, s: VIOState, fes: FrontendState,
                  image) -> Tuple[VIOState, FrontendState]:
    """One tracker update from (B, H, W) images."""
    fr = s.features
    gr = s.groups
    NF = fr.fid.shape[-1]
    NG = gr.gid.shape[-1]
    dev = fr.xp.device
    kind = cam_mod.MODEL_IDS[cfg.cam_model]

    pyr_new = tuple(build_pyramid(image.to(torch.float32),
                                  cfg.klt_max_level))
    active = fr.active

    # initial guesses: filter prediction (Feature::Predict) or previous
    # position (use_prediction=false, the TUM-VI setting)
    if cfg.use_prediction:
        grow = torch.clamp(fr.ref, 0, NG - 1)
        xp_pred, _ = predict_pixel(kind, s.cam[:, None], bcast_X(s.X),
                                   take_rows(gr.Rsb, grow),
                                   take_rows(gr.Tsb, grow), fr.x)
        guesses = _where(fr.ref >= 0, xp_pred, fr.xp)
    else:
        guesses = fr.xp

    new_xy, ok = track(list(fes.pyr), list(pyr_new), fr.xp, guesses, active,
                       win_size=cfg.klt_win_size, iters=cfg.klt_max_iter,
                       eps=cfg.klt_eps)
    # first frame: nothing to track against
    ok = ok & fes.initialized[:, None]
    disp_ok = torch.linalg.vector_norm(new_xy - fr.xp, dim=-1) \
        < cfg.max_pixel_displacement
    tracked = active & ok & disp_ok
    s = s._replace(n_tracker_rejected=torch.zeros_like(s.n_tracker_rejected))
    img_smooth = blur5(pyr_new[0])

    if cfg.extract_descriptor and cfg.descriptor_distance_thresh > 0:
        # descriptor-drift check on tracked points (src/tracker.cpp:
        # 520-560): re-extract at the new position, drop tracks whose
        # descriptor changed too much
        new_desc = brief.extract(img_smooth, new_xy)
        keep_desc = brief.hamming(fr.desc, new_desc) \
            < cfg.descriptor_distance_thresh
        tracked = tracked & keep_desc
        fr = fr._replace(desc=_where(tracked, new_desc, fr.desc))

    dropped = active & ~tracked
    fr = fr._replace(
        track=torch.where(tracked, TS_TRACKED,
                          torch.where(dropped, TS_DROPPED, fr.track)),
        xp=_where(tracked, new_xy.to(fr.xp.dtype), fr.xp))

    # detection when the live-track count falls below num_features_min
    n_live = torch.sum(tracked.to(torch.int64), dim=-1, keepdim=True)
    need = n_live < cfg.num_features_min
    budget = torch.clamp(cfg.num_features_max - n_live, min=0)

    # the detector factory (src/tracker.cpp:36-97), FAST only
    score = nms3(fast_score(pyr_new[0], cfg.fast_threshold))
    det_xy, det_score, det_ok = select_topk(
        score, K_DET, cfg.margin, fr.xp, tracked, cfg.mask_size)
    det_ok = det_ok & need & (torch.arange(K_DET, device=dev) < budget)

    if cfg.extract_descriptor:
        descs = brief.extract(img_smooth, det_xy)
    else:
        descs = torch.zeros(det_xy.shape[:-1] + (8,), dtype=torch.int64,
                            device=dev)

    if cfg.match_dropped_tracks and cfg.extract_descriptor:
        # dropped-track rescue (src/tracker.cpp:245-311): match fresh
        # detections against just-dropped tracks by descriptor distance
        # and displacement; revive instead of re-creating
        dthresh = cfg.descriptor_distance_thresh \
            if cfg.descriptor_distance_thresh > 0 else 50
        D = brief.hamming_matrix(fr.desc, descs)              # (B, NF, K)
        disp = torch.linalg.vector_norm(
            fr.xp[..., :, None, :] - det_xy[..., None, :, :], dim=-1)
        match_ok = dropped[..., :, None] & det_ok[..., None, :] \
            & (D < dthresh) & (disp < cfg.max_pixel_displacement)
        Dm = torch.where(match_ok, D, 10_000)
        best_det = torch.argmin(Dm, dim=-1)                   # (B, NF)
        has = torch.amin(Dm, dim=-1) < 10_000
        # one detection revives at most one track: the first track whose
        # best detection it is
        det_oh = torch.where(has, best_det, K_DET)[..., None] \
            == torch.arange(K_DET, device=dev)                # (B, NF, K)
        first_track = torch.argmax(det_oh.to(torch.int32), dim=-2)
        claimed_by = torch.where(torch.any(det_oh, dim=-2), first_track, -1)
        best_c = torch.clamp(best_det, 0, K_DET - 1)
        revive = has & (torch.gather(claimed_by, -1, best_c)
                        == torch.arange(NF, device=dev))
        rx = take_rows(det_xy, best_c)
        fr = fr._replace(
            track=torch.where(revive, TS_TRACKED, fr.track),
            xp=_where(revive, rx.to(fr.xp.dtype), fr.xp))
        tracked = tracked | revive
        used = torch.any(revive[..., None]
                         & (best_det[..., None]
                            == torch.arange(K_DET, device=dev)), dim=-2)
        det_ok = det_ok & ~used

    s, fr = _spawn_detections(s, fr, det_xy, det_score, descs, det_ok,
                              free=~fr.active & ~tracked)
    s = s._replace(features=fr)
    fes = FrontendState(pyr=pyr_new,
                        initialized=torch.ones_like(fes.initialized))
    return s, fes


def _spawn_detections(s: VIOState, fr, det_xy, det_score, descs, det_ok,
                      free):
    """Create new tracks from detections (B, K) into free slots (B, NF)
    (Feature::Create path of src/tracker.cpp:312-328,440-457)."""
    NF = fr.fid.shape[-1]
    dev = fr.fid.device
    slot_of_det, got = _rank_assign(free, det_ok, -det_score)
    tgt = torch.where(got, slot_of_det, NF)
    new_fids = s.next_fid[:, None] + torch.cumsum(got.to(torch.int64),
                                                  dim=-1) - 1
    oh = tgt[..., :, None] == torch.arange(NF, device=dev)    # (B, K, NF)
    hit = torch.any(oh, dim=-2)
    put_fid = torch.sum(oh * new_fids[..., None], dim=-2)
    put_xy = oh.to(fr.xp.dtype).transpose(-1, -2) @ det_xy.to(fr.xp.dtype)
    put_desc = torch.sum(oh[..., None] * descs[..., :, None, :], dim=-3)
    fr = fr._replace(
        fid=torch.where(hit, put_fid, fr.fid),
        status=torch.where(hit, FS_CREATED, fr.status),
        track=torch.where(hit, TS_CREATED, fr.track),
        ref=torch.where(hit, -1, fr.ref),
        sind=torch.where(hit, -1, fr.sind),
        init_counter=torch.where(hit, 0, fr.init_counter),
        lifetime=torch.where(hit, 0, fr.lifetime),
        outlier_counter=torch.where(hit, 0.0, fr.outlier_counter),
        xp=_where(hit, put_xy, fr.xp),
        tri_ok=fr.tri_ok & ~hit,
        adj=fr.adj & ~hit[..., None],
        sim_depth=torch.where(hit, -1.0, fr.sim_depth),
        desc=_where(hit, put_desc, fr.desc))
    s = s._replace(next_fid=s.next_fid + torch.sum(got.to(torch.int64),
                                                   dim=-1))
    return s, fr


def vio_frame_image(cfg: VIOConfig, s: VIOState, fes: FrontendState,
                    imu_gyro, imu_accel, imu_dt, frame_dt, image):
    """Image-mode frame step for B sequences (the TUM-VI path): IMU
    propagation + LK tracker + filter update. Returns (state, front-end
    state, StepOutputs)."""
    check_supported(cfg)
    s = propagate_frame(cfg, s, imu_gyro, imu_accel, imu_dt, frame_dt)
    s, fes = tracker_image(cfg, s, fes, image)
    s, out = update_step(cfg, s)
    return s, fes, out


def tracker_only_frame(cfg: VIOConfig, s: VIOState, fes: FrontendState,
                       image):
    """Front-end-only step (the feature_tracker_only app,
    src/app/feature_tracker_only.cpp): track + detect, no filter. With no
    filter to consume TS_DROPPED rows, they are freed here at the start of
    the next frame, so slots recycle."""
    check_supported(cfg)
    fr = s.features
    stale = fr.active & (fr.track == TS_DROPPED)
    s = s._replace(features=_clear_feature_rows(fr, stale))
    return tracker_image(cfg, s, fes, image)
