"""Mapped VIO frame steps: filter + retirement + loop closure (port of
``xivo_tpu/map/integration.py``).

Retirement feeds the map when in-state features leave the tracker
(Estimator::DiscardFeatures -> Mapper::AddFeature,
src/estimator.cpp:1337-1349), a periodic keyframe snapshot feeds it too,
and CloseLoop runs after each visual update (src/app/vio.cpp:75-77). Each
step takes the frame's RANSAC draws ``uniforms`` (B, n_hyps, F)
(``map/p3p.py``) and, with ``cfg.do_outlier_rejection``, the tracker's
homography draws ``hom_uniforms`` (B, N_HYPS, NF) (``frontend/
homography.py``; the reference splits the tracker's key before
``close_loop``'s).
"""
from __future__ import annotations

import torch

from ..filter.config import VIOConfig
from ..filter.pipeline import propagate_frame, tracker_pointcloud, update_step
from ..filter.state import TS_DROPPED, TS_TRACKED, VIOState, check_supported
from .mapper import MapState, close_loop, retire_features


def _keyframe_insert(cfg: VIOConfig, s: VIOState, ms: MapState):
    """Every ``cfg.lc_keyframe_every`` frames, a snapshot of the tracked
    in-state features into the map (run every frame under a mask)."""
    if cfg.lc_keyframe_every <= 0:
        return ms
    fr = s.features
    do = (s.vision_counter % cfg.lc_keyframe_every) == 0
    mask = fr.active & (fr.sind >= 0) & (fr.track == TS_TRACKED) \
        & do[:, None]
    return retire_features(cfg, s, ms, mask)


def _map_and_close(cfg: VIOConfig, s: VIOState, ms: MapState, uniforms):
    """After the tracker: retire the dropped in-state features, update,
    snapshot a keyframe, close loops. Returns (s, ms, outputs, closures)."""
    fr = s.features
    # dropped in-state features still carry their state here
    retire = fr.active & (fr.track == TS_DROPPED) & (fr.sind >= 0)
    ms = retire_features(cfg, s, ms, retire)
    s, out = update_step(cfg, s)
    ms = _keyframe_insert(cfg, s, ms)
    if cfg.detect_loop_closures:
        s, n_lc = close_loop(cfg, s, ms, uniforms,
                             nn_dist_thresh=cfg.lc_nn_dist_thresh,
                             ransac_thresh=cfg.lc_ransac_thresh,
                             min_matches=cfg.lc_min_matches)
    else:
        n_lc = torch.zeros_like(s.vision_counter)
    return s, ms, out, n_lc


def vio_frame_mapped(cfg: VIOConfig, s: VIOState, ms: MapState, imu_gyro,
                     imu_accel, imu_dt, frame_dt, meas_id, meas_xp,
                     meas_depth, meas_valid, uniforms, hom_uniforms=None):
    """Point-cloud frame step with mapping + loop closure for B sequences.
    Returns (state, map, StepOutputs, closure rows (B,))."""
    check_supported(cfg)
    s = propagate_frame(cfg, s, imu_gyro, imu_accel, imu_dt, frame_dt)
    s = tracker_pointcloud(cfg, s, meas_id, meas_xp, meas_depth, meas_valid,
                           hom_uniforms)
    return _map_and_close(cfg, s, ms, uniforms)


def vio_frame_image_mapped(cfg: VIOConfig, s: VIOState, fes, ms: MapState,
                           imu_gyro, imu_accel, imu_dt, frame_dt, image,
                           uniforms, hom_uniforms=None):
    """Image frame step with mapping + loop closure for B sequences.
    Returns (state, front-end state, map, StepOutputs, closure rows)."""
    from ..frontend.tracker import tracker_image
    check_supported(cfg)
    s = propagate_frame(cfg, s, imu_gyro, imu_accel, imu_dt, frame_dt)
    s, fes = tracker_image(cfg, s, fes, image, hom_uniforms)
    s, ms, out, n_lc = _map_and_close(cfg, s, ms, uniforms)
    return s, fes, ms, out, n_lc
