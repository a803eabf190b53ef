"""Batched execution of the VIO pipeline (port of ``xivo_tpu/runner.py``).

``pack_frame_inputs`` packs a host stream into numpy arrays (bit-equal to
the reference's packing); ``run_batch`` moves B packed streams to the
device and runs T frames as a Python loop over ``vio_frame`` with the
batch axis written out; ``make_sequence_runner`` is the same for one
sequence without a batch axis. ``run_batch_image`` does the same for image
mode over ``vio_frame_image``; ``run_batch_mapped`` and
``run_batch_image_mapped`` run the mapped steps (``map/integration.py``)
with a map per sequence (``batch_maps``), drawing each frame's RANSAC
uniforms on the device from a seeded ``torch.Generator``. With
``cfg.do_outlier_rejection`` every runner also draws each frame's
homography uniforms (B, N_HYPS, NF) there, in the states' dtype, before
the frame's RANSAC draws (the reference splits the tracker's key first;
``frame_draws`` keeps that order for the runners and the Estimator);
``hom_uniforms`` (B, T, N_HYPS, NF) replaces them. The loops read
nothing back to the host until the last frame has been enqueued.
``make_sharded_runner`` spreads the batch over the ranks of a
``torch.distributed`` group (``dist/multihost.py``): each rank runs its
rows through ``run_batch`` and gathers the results.

Where the config propagates through the capped substep loops
(``propagate.uses_substep_loop``), each runner zeroes the loops' device
counters before its first frame and, unless called with ``check=False``,
reads them once after its last and raises if the cap left an interval
unfinished. ``fit_substeps`` sizes the cap from a packed stream.

Each runner's frame loop opens a ``tracing.FRAME`` span around a frame's
draws and step (off unless ``tracing.enable()`` was called).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from . import tracing
from .filter import propagate
from .filter.config import VIOConfig
from .filter.pipeline import StepOutputs, vio_frame
from .filter.state import VIOState, init_state, tree_map
from .frontend.homography import N_HYPS as HOM_N_HYPS
from .frontend.tracker import FrontendState, init_frontend, vio_frame_image
from .map.integration import vio_frame_image_mapped, vio_frame_mapped
from .map.mapper import MapState, init_map
from .map.p3p import N_HYPS


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


def batch_maps(capacity: int, B: int, device="cuda",
               dtype=torch.float32) -> MapState:
    """B empty maps of `capacity` entries (leading batch axis)."""
    ms = init_map(capacity, dtype, device)
    return tree_map(lambda x: x.expand((B,) + x.shape).clone(), ms)


def batch_frontend_states(cfg: VIOConfig, B: int,
                          device="cuda") -> FrontendState:
    """B copies of the initial front-end state (leading batch axis)."""
    fes = init_frontend(cfg, device)
    return FrontendState(
        pyr=tuple(p.expand((B,) + p.shape).clone() for p in fes.pyr),
        initialized=fes.initialized.expand(B).clone())


def _fixed_substeps(dt, h0, dtype) -> int:
    """Substeps of the fixed-step loop (h0, the half-step trick) over one
    interval dt, in the arithmetic of `dtype`, as the device runs it."""
    dt, h0c, total, n = dtype(dt), dtype(h0), dtype(0), 0
    lo, hi, half = dtype(h0), dtype(1.5 * h0), dtype(0.5 * h0)
    while total < dt:
        rem = dtype(dt - total)
        h = half if lo < rem < hi else min(h0c, rem)
        total, n = dtype(total + h), n + 1
    return n


def fit_substeps(cfg: VIOConfig, fis) -> VIOConfig:
    """cfg with ``max_substeps`` sized to a packed host stream (numpy
    ``FrameInputs`` or ``ImageInputs``, any leading axes): the most
    substeps the fixed-step loops take over any of its IMU intervals or
    frame segments (one more with online temporal calibration, whose
    frame segment moves with the td estimate). Adaptive Prince-Dormand
    steps depend on the data, so such a config keeps its ``max_substeps``;
    configs that take no loop are returned as they are."""
    if not propagate.uses_substep_loop(cfg) or (
            cfg.propagation_mode == "reference" and cfg.pd_control_stepsize
            and cfg.integration_method == "PrinceDormand"):
        return cfg
    dts = np.concatenate([np.ravel(fis.imu_dt), np.ravel(fis.frame_dt)])
    dtype = np.result_type(dts.dtype, np.dtype(cfg.dtype)).type
    n = max((_fixed_substeps(dt, cfg.stepsize, dtype)
             for dt in np.unique(dts[dts > 0])), default=1)
    return dataclasses.replace(
        cfg, max_substeps=n + int(bool(cfg.online_temporal_calib)))


def _checked(cfg: VIOConfig, device, check: bool, loop):
    """Run loop() with the substep counters of `device` zeroed first and,
    with `check`, read after it (see the module docstring)."""
    if not propagate.uses_substep_loop(cfg):
        return loop()
    propagate.reset_substep_counts(device)
    out = loop()
    if check:
        propagate.check_substeps(device)
    return out


def run_batch(cfg: VIOConfig, states: VIOState, fis: FrameInputs,
              check: bool = True, seed: int = 0, hom_uniforms=None,
              rows=None):
    """Run B sequences of T frames. fis: (B, T, ...) tensors on the
    states' device. Returns (final state, StepOutputs stacked (B, T, ...)).
    ``rows`` (offset, total): the B sequences are rows offset..offset+B-1
    of a batch of `total`, and each frame's draws are taken for the whole
    batch and cut to those rows, so that they equal the whole batch's."""
    gen = draw_generator(states, seed)

    def loop():
        s = states
        outs = []
        for t in range(fis.frame_dt.shape[1]):
            with tracing.span(tracing.FRAME):
                hom, _ = frame_draws(cfg, s, gen, False, t, hom_uniforms,
                                     rows=rows)
                s, out = vio_frame(cfg, s, *(a[:, t] for a in fis), hom)
            outs.append(out)
        return s, _stack(outs)
    return _checked(cfg, states.P.device, check, loop)


def make_batch_runner(cfg: VIOConfig):
    """(states, FrameInputs) -> (states, StepOutputs), the reference's
    runner signature; host inputs are moved to the states' device and the
    substep cap is sized to them (``fit_substeps``)."""
    def run(states: VIOState, fis: FrameInputs):
        return run_batch(fit_substeps(cfg, fis), states,
                         inputs_to_device(fis, states.P.device))
    return run


def make_sharded_runner(cfg: VIOConfig, group=None):
    """``make_batch_runner`` with the batch spread over the ranks of a
    ``torch.distributed`` group (``dist.multihost.global_mesh()`` without
    one): the counterpart of the reference's ``shard_map`` with every leaf
    split along its leading axis. run(states, fis, seed=0, check=True)
    takes the global (B, ...) states, on the rank's device, and inputs,
    numpy as ``pack_frame_inputs`` packs them (the substep cap sized to
    the whole stream, so that every rank runs one program) or tensors on
    that device (cfg's cap). Each rank runs its rows through
    ``dist.multihost.make_multihost_runner``, and every rank returns the
    whole batch's final states and outputs, gathered along the batch
    axis. B must divide by n."""
    from .dist.multihost import (global_mesh, global_to_host_local,
                                 host_local_to_global, make_multihost_runner)
    group = global_mesh() if group is None else group

    def run(states: VIOState, fis: FrameInputs, seed: int = 0,
            check: bool = True):
        host = isinstance(fis.frame_dt, np.ndarray)
        c = fit_substeps(cfg, fis) if host else cfg
        mine, fis = global_to_host_local((states, fis), group)
        if host:
            fis = inputs_to_device(fis, states.P.device)
        return host_local_to_global(make_multihost_runner(c, group)(
            mine, fis, seed=seed, check=check), group)
    return run


def make_sequence_runner(cfg: VIOConfig):
    """(state, FrameInputs) -> (state, StepOutputs stacked (T, ...)) for
    ONE sequence, without a batch axis: the state as ``init_state`` makes
    it, the inputs on the host as ``pack_frame_inputs`` packs them.
    ``make_batch_runner`` at B = 1: the batch axis is added, the frames
    run, and the axis is taken off again."""
    run_b = make_batch_runner(cfg)

    def run(state: VIOState, fi: FrameInputs):
        s, outs = run_b(tree_map(lambda x: x[None], state),
                        FrameInputs(*(np.asarray(a)[None] for a in fi)))
        return tree_map(lambda x: x[0], s), tree_map(lambda x: x[0], outs)
    return run


def run_batch_image(cfg: VIOConfig, states: VIOState, fes: FrontendState,
                    fis: ImageInputs, check: bool = True, seed: int = 0,
                    hom_uniforms=None):
    """Run B image-mode sequences of T frames. fis: (B, T, ...) tensors on
    the states' device. Returns (final state, final front-end state,
    StepOutputs stacked (B, T, ...))."""
    gen = draw_generator(states, seed)

    def loop():
        s, f = states, fes
        outs = []
        for t in range(fis.frame_dt.shape[1]):
            with tracing.span(tracing.FRAME):
                hom, _ = frame_draws(cfg, s, gen, False, t, hom_uniforms)
                s, f, out = vio_frame_image(cfg, s, f,
                                            *(a[:, t] for a in fis), hom)
            outs.append(out)
        return s, f, _stack(outs)
    return _checked(cfg, states.P.device, check, loop)


def draw_generator(s: VIOState, seed: int = 0) -> torch.Generator:
    """The seeded generator on the states' device that a runner, or the
    Estimator, takes a run's uniforms from (``frame_draws``)."""
    gen = torch.Generator(device=s.P.device)
    gen.manual_seed(seed)
    return gen


def frame_draws(cfg: VIOConfig, s: VIOState, gen, mapped: bool, t: int = 0,
                hom_uniforms=None, uniforms=None, rows=None):
    """Frame t's uniforms (homography, P3P), taken from `gen` in the one
    order that every runner and the Estimator keep: the tracker's
    homography draws (B, HOM_N_HYPS, NF) first, None where the config
    rejects no outliers; then, for a `mapped` step, loop closure's P3P
    RANSAC draws (B, N_HYPS, F), else None. Both in the states' dtype on
    their device; a given (B, T, ...) `hom_uniforms` or `uniforms`
    tensor's frame t replaces the draws of its kind. ``rows`` (offset,
    total) draws the homography uniforms for a batch of `total` and keeps
    the states' B rows from offset on (``run_batch``); a mapped step
    takes no `rows`."""
    if mapped and rows is not None:
        raise ValueError("rows= cuts the homography draws alone")
    hom = p3p = None
    if cfg.do_outlier_rejection:
        hom = (_uniform(s, (HOM_N_HYPS, s.features.fid.shape[-1]), gen,
                        rows)
               if hom_uniforms is None else hom_uniforms[:, t])
    if mapped:
        p3p = p3p_draws(cfg, s, gen) if uniforms is None else uniforms[:, t]
    return hom, p3p


def p3p_draws(cfg: VIOConfig, s: VIOState, gen):
    """Loop closure's P3P RANSAC draws (B, N_HYPS, F) from `gen`."""
    return _uniform(s, (N_HYPS, cfg.dims.n_features), gen)


def _uniform(s: VIOState, shape, gen, rows=None):
    B = s.P.shape[0]
    lo, total = (0, B) if rows is None else rows
    u = torch.rand((total,) + tuple(shape), generator=gen, dtype=s.P.dtype,
                   device=s.P.device)
    return u if rows is None else u[lo:lo + B]


def _stack(outs):
    return StepOutputs(*(torch.stack(o, dim=1) for o in zip(*outs)))


def _run_mapped(cfg, step, carry, fis, seed, uniforms, hom_uniforms,
                check):
    """The mapped frame loop: ``step(*carry, *inputs of frame t, RANSAC
    draws, homography draws)`` returns (*carry, StepOutputs, closure rows)
    for every frame t."""
    s0 = carry[0]
    gen = draw_generator(s0, seed)

    def loop():
        c = carry
        outs, lcs = [], []
        for t in range(fis.frame_dt.shape[1]):
            with tracing.span(tracing.FRAME):
                h, u = frame_draws(cfg, c[0], gen, True, t, hom_uniforms,
                                   uniforms)
                *c, out, n_lc = step(*c, *(a[:, t] for a in fis), u, h)
            outs.append(out)
            lcs.append(n_lc)
        return (*c, _stack(outs), torch.stack(lcs, dim=1))
    return _checked(cfg, s0.P.device, check, loop)


def run_batch_mapped(cfg: VIOConfig, states: VIOState, maps: MapState,
                     fis: FrameInputs, seed: int = 0, uniforms=None,
                     check: bool = True, hom_uniforms=None):
    """Run B mapped sequences of T frames (``vio_frame_mapped``). fis:
    (B, T, ...) tensors on the states' device; ``uniforms`` (B, T, n_hyps,
    F), if given, replaces the seeded RANSAC draws (``hom_uniforms`` the
    homography draws). Returns (final state, final map, StepOutputs
    stacked (B, T, ...), closure rows (B, T))."""
    return _run_mapped(cfg, partial(vio_frame_mapped, cfg), (states, maps),
                       fis, seed, uniforms, hom_uniforms, check)


def run_batch_image_mapped(cfg: VIOConfig, states: VIOState,
                           fes: FrontendState, maps: MapState,
                           fis: ImageInputs, seed: int = 0, uniforms=None,
                           check: bool = True, hom_uniforms=None):
    """``run_batch_mapped`` for image mode (``vio_frame_image_mapped``).
    Returns (state, front-end state, map, StepOutputs, closure rows)."""
    return _run_mapped(cfg, partial(vio_frame_image_mapped, cfg),
                       (states, fes, maps), fis, seed, uniforms,
                       hom_uniforms, check)
