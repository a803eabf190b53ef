"""Segment-parallel processing of long trajectories (port of
``xivo_tpu/dist/segments.py``; its docstring gives the design).

A long stream is split into S overlapping segments, each cold-started by
the closed-form visual-inertial initializer (``filter/vi_init.py``), run
as one batch (the batch runner, or ``runner.make_sharded_runner`` to
spread the segments over the ranks of a process group) and fused by a
yaw + translation alignment of the overlaps. The planning, splitting and
fusion are numpy on the host; the seeding and the filter run on the
device given.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..filter import layout as L
from ..filter.config import VIOConfig
from ..filter.state import VIOState, init_state, torch_dtype, tree_map
from ..filter.vi_init import vi_bootstrap
from ..runner import FrameInputs, make_batch_runner


class SegmentPlan(NamedTuple):
    starts: np.ndarray      # (S,) segment start frames
    seg_len: int            # frames per segment INCLUDING overlap
    core_len: int           # frames each segment contributes
    overlap: int


def plan_segments(T: int, n_segments: int, overlap: int) -> SegmentPlan:
    core = math.ceil(T / n_segments)
    starts = np.arange(n_segments) * core
    return SegmentPlan(starts=starts, seg_len=core + overlap, core_len=core,
                       overlap=overlap)


def split_stream(fi: FrameInputs, plan: SegmentPlan) -> FrameInputs:
    """S overlapping segment views of a packed stream, stacked: (S, L,
    ...). Segment k > 0's first packed IMU row belongs to the previous
    frame interval, so it is zeroed: the seeded state is defined at the
    segment's first frame time."""
    T = fi.frame_dt.shape[0]
    L_ = plan.seg_len

    def seg(x):
        pads = [(0, plan.starts[-1] + L_ - T)] + [(0, 0)] * (x.ndim - 1)
        xp = np.pad(np.asarray(x), pads)
        return np.stack([xp[s:s + L_] for s in plan.starts])

    out = FrameInputs(*[seg(x) for x in fi])
    imu_dt = np.asarray(out.imu_dt).copy()
    frame_dt = np.asarray(out.frame_dt).copy()
    imu_dt[1:, 0, :] = 0.0
    frame_dt[1:, 0] = 0.0
    return out._replace(imu_dt=imu_dt, frame_dt=frame_dt)


def seed_segment_states(cfg: VIOConfig, fis: FrameInputs, boot_frames: int,
                        v_std: float = 0.5, att_std: float = 0.1,
                        device="cuda") -> VIOState:
    """The S segments' cold starts: ``vi_bootstrap`` on each segment's
    first `boot_frames` frames (one call a segment), giving (S,)-batched
    states with the gravity-aligned attitude, the bootstrapped velocity,
    the held IMU signals of the segment's first sample and the priors
    opened by the initializer's expected error (v_std; att_std roll and
    pitch, yaw being gauge)."""
    S = fis.frame_dt.shape[0]
    s0 = init_state(cfg, device)
    dt, dev = torch_dtype(cfg), s0.P.device
    use_depths = bool(getattr(cfg, "sim_initialize_depths", False))

    def t(a, dtype=dt):
        a = np.asarray(a)
        if a.dtype.kind in "iu":
            dtype = torch.int64
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    w = slice(0, boot_frames)
    boots = [vi_bootstrap(
        cfg, s0.cam, t(fis.gyro[k, w]), t(fis.accel[k, w]),
        t(fis.imu_dt[k, w]), t(fis.frame_dt[k, w]), t(fis.meas_id[k, w]),
        t(fis.meas_xp[k, w]), t(fis.meas_valid[k, w], torch.bool),
        meas_depth=t(fis.meas_depth[k, w]) if use_depths else None)
        for k in range(S)]

    sb = tree_map(lambda x: x.expand((S,) + x.shape).clone(), s0)
    X = sb.X._replace(Rsb=torch.stack([b.Rsb0 for b in boots]),
                      Vsb=torch.stack([b.Vsb0 for b in boots]))
    D = cfg.dims.full
    extra = torch.zeros((D,), dtype=dt, device=dev)
    extra[L.WSB:L.WSB + 3] = att_std ** 2
    extra[L.VSB:L.VSB + 3] = v_std ** 2
    if cfg.covariance_form == "sqrt":
        # the fresh factor is diagonal: widen it in std space
        idx = torch.arange(D, device=dev)
        P = sb.P.clone()
        P[:, idx, idx] = torch.sqrt(sb.P[:, idx, idx] ** 2 + extra[None])
    else:
        P = sb.P + torch.diag(extra)[None]
    return sb._replace(X=X, P=P, last_gyro=t(fis.gyro[:, 1, 0, :]),
                       last_accel=t(fis.accel[:, 1, 0, :]))


def yaw_translation_align(p_ref: np.ndarray, p_src: np.ndarray):
    """4-DoF alignment: Rz(theta) @ p_src + t ~= p_ref (least squares)."""
    mr = p_ref.mean(axis=0)
    ms = p_src.mean(axis=0)
    a = p_ref - mr
    b = p_src - ms
    num = np.sum(b[:, 0] * a[:, 1] - b[:, 1] * a[:, 0])
    den = np.sum(b[:, 0] * a[:, 0] + b[:, 1] * a[:, 1])
    th = math.atan2(num, den)
    c, s = math.cos(th), math.sin(th)
    Rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return Rz, mr - Rz @ ms


def fuse_segments(Tsb_segs: np.ndarray, plan: SegmentPlan, T: int
                  ) -> np.ndarray:
    """Chain segments into one trajectory: Tsb_segs (S, L, 3), each
    segment's positions in its own frame, aligned in turn to the
    trajectory fused so far on its first `overlap` frames, blended
    linearly over them, and taken alone after them."""
    S, L_, _ = Tsb_segs.shape
    fused = np.zeros((plan.starts[-1] + L_, 3))
    fused[:L_] = Tsb_segs[0]
    end = L_
    for k in range(1, S):
        s0 = plan.starts[k]
        ov = min(plan.overlap, end - s0)
        Rz, t = yaw_translation_align(fused[s0:s0 + ov],
                                      np.asarray(Tsb_segs[k][:ov]))
        aligned = (Rz @ np.asarray(Tsb_segs[k]).T).T + t
        w = np.linspace(0.0, 1.0, ov)[:, None]
        fused[s0:s0 + ov] = (1 - w) * fused[s0:s0 + ov] + w * aligned[:ov]
        fused[s0 + ov:s0 + L_] = aligned[ov:]
        end = s0 + L_
    return fused[:T]


def run_segment_parallel(cfg: VIOConfig, fi: FrameInputs, n_segments: int,
                         overlap: int = 20, boot_frames: int = 16,
                         runner=None, device="cuda"):
    """Segment-parallel VIO over one packed stream (numpy, as
    ``pack_frame_inputs`` packs it). Returns (fused Tsb (T, 3), the
    segments' StepOutputs (S, L, ...)). `runner`, run(states, numpy
    inputs) -> (states, outputs), defaults to the batch runner; pass
    ``runner.make_sharded_runner(cfg, group)`` to spread the segments over
    the group's ranks."""
    T = fi.frame_dt.shape[0]
    plan = plan_segments(T, n_segments, overlap)
    fis = split_stream(fi, plan)
    states = seed_segment_states(cfg, fis, boot_frames, device=device)
    run = runner if runner is not None else make_batch_runner(cfg)
    _, outs = run(states, fis)
    fused = fuse_segments(outs.Tsb.double().cpu().numpy(), plan, T)
    return fused, outs
