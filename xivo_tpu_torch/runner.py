"""Batched execution of the VIO pipeline (port of ``xivo_tpu/runner.py``).

``pack_frame_inputs`` packs a host stream into numpy arrays (bit-equal to
the reference's packing); ``run_batch`` moves B packed streams to the
device and runs T frames as a Python loop over ``vio_frame`` with the
batch axis written out. ``run_batch_image`` does the same for image mode
over ``vio_frame_image``. The loops read nothing back to the host until
the last frame has been enqueued.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .filter.config import VIOConfig
from .filter.pipeline import StepOutputs, vio_frame
from .filter.state import VIOState, init_state, tree_map
from .frontend.tracker import FrontendState, init_frontend, vio_frame_image


class FrameInputs(NamedTuple):
    """Per-frame packed inputs; arrays lead with the frame axis T (and,
    batched, with B before it)."""
    gyro: np.ndarray        # (T, KI, 3)
    accel: np.ndarray       # (T, KI, 3)
    imu_dt: np.ndarray      # (T, KI)
    frame_dt: np.ndarray    # (T,)
    meas_id: np.ndarray     # (T, M) int32, -1 invalid
    meas_xp: np.ndarray     # (T, M, 2)
    meas_depth: np.ndarray  # (T, M)
    meas_valid: np.ndarray  # (T, M) bool


def pack_frame_inputs(frames, imu_cap=32, meas_cap=256, dtype=np.float32):
    """Host-side packing of a measurement stream (dicts with keys imu =
    [(dt, gyro, accel)], frame_dt, ids, xp, depth). The IMU axis is trimmed
    to the actual max samples per frame."""
    T = len(frames)
    need = max((len(f["imu"]) for f in frames), default=1)
    imu_cap = max(1, min(imu_cap, need))
    gyro = np.zeros((T, imu_cap, 3), dtype)
    accel = np.zeros((T, imu_cap, 3), dtype)
    imu_dt = np.zeros((T, imu_cap), dtype)
    frame_dt = np.zeros((T,), dtype)
    meas_id = np.full((T, meas_cap), -1, np.int32)
    meas_xp = np.zeros((T, meas_cap, 2), dtype)
    meas_depth = np.full((T, meas_cap), -1.0, dtype)
    meas_valid = np.zeros((T, meas_cap), bool)
    for t, f in enumerate(frames):
        for i, (dt, gy, ac) in enumerate(f["imu"][:imu_cap]):
            imu_dt[t, i] = dt
            gyro[t, i] = gy
            accel[t, i] = ac
        frame_dt[t] = f["frame_dt"]
        n = min(len(f["ids"]), meas_cap)
        meas_id[t, :n] = f["ids"][:n]
        meas_xp[t, :n] = f["xp"][:n]
        meas_depth[t, :n] = f["depth"][:n]
        meas_valid[t, :n] = True
    return FrameInputs(gyro, accel, imu_dt, frame_dt, meas_id, meas_xp,
                       meas_depth, meas_valid)


def inputs_to_device(fis: FrameInputs, device) -> FrameInputs:
    """Batched (B, T, ...) host inputs -> tensors (ids as int64)."""
    def conv(a):
        t = torch.from_numpy(np.array(a))
        if t.dtype == torch.int32:
            t = t.to(torch.int64)
        return t.to(device)
    return FrameInputs(*(conv(a) for a in fis))


class ImageInputs(NamedTuple):
    """Per-frame image-mode inputs; arrays lead with the frame axis T (and,
    batched, with B before it)."""
    gyro: np.ndarray        # (T, KI, 3)
    accel: np.ndarray       # (T, KI, 3)
    imu_dt: np.ndarray      # (T, KI)
    frame_dt: np.ndarray    # (T,)
    image: np.ndarray       # (T, H, W) float32


def image_inputs_to_device(fi: ImageInputs, device, batch: int = None):
    """Image-mode host inputs -> tensors on ``device``, in one copy before
    the frame loop. With ``batch``, fi is one (T, ...) stream and every
    sequence of the batch sees it: the result is its (B, T, ...) expand,
    a view, not B copies. Without, fi is already (B, T, ...)."""
    def conv(a):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return t if batch is None else t.expand((batch,) + t.shape)
    return ImageInputs(*(conv(a) for a in fi))


def batch_states(cfg: VIOConfig, B: int, device="cuda") -> VIOState:
    """B copies of the initial state (leading batch axis)."""
    s = init_state(cfg, device)
    return tree_map(lambda x: x.expand((B,) + x.shape).clone(), s)


def batch_frontend_states(cfg: VIOConfig, B: int,
                          device="cuda") -> FrontendState:
    """B copies of the initial front-end state (leading batch axis)."""
    fes = init_frontend(cfg, device)
    return FrontendState(
        pyr=tuple(p.expand((B,) + p.shape).clone() for p in fes.pyr),
        initialized=fes.initialized.expand(B).clone())


def run_batch(cfg: VIOConfig, states: VIOState, fis: FrameInputs):
    """Run B sequences of T frames. fis: (B, T, ...) tensors on the
    states' device. Returns (final state, StepOutputs stacked (B, T, ...))."""
    s = states
    outs = []
    for t in range(fis.frame_dt.shape[1]):
        s, out = vio_frame(cfg, s, *(a[:, t] for a in fis))
        outs.append(out)
    return s, StepOutputs(*(torch.stack(o, dim=1) for o in zip(*outs)))


def make_batch_runner(cfg: VIOConfig):
    """(states, FrameInputs) -> (states, StepOutputs), the reference's
    runner signature; host inputs are moved to the states' device."""
    def run(states: VIOState, fis: FrameInputs):
        return run_batch(cfg, states, inputs_to_device(fis, states.P.device))
    return run


def run_batch_image(cfg: VIOConfig, states: VIOState, fes: FrontendState,
                    fis: ImageInputs):
    """Run B image-mode sequences of T frames. fis: (B, T, ...) tensors on
    the states' device. Returns (final state, final front-end state,
    StepOutputs stacked (B, T, ...))."""
    s = states
    outs = []
    for t in range(fis.frame_dt.shape[1]):
        s, fes, out = vio_frame_image(cfg, s, fes, *(a[:, t] for a in fis))
        outs.append(out)
    return s, fes, StepOutputs(*(torch.stack(o, dim=1) for o in zip(*outs)))
