"""Fast propagation's chain over a frame's IMU slots and its visual
segment: the transition Phi and the accumulated noise Q of the motion
block, and the nominal motion at the frame time.

``imu_chain`` computes, for B sequences at once, what the reference's
``_propagate_frame_fast`` (``xivo_tpu/filter/pipeline.py:1246``) scans
over the slots before it touches the covariance: for each slot with
dt > 0 the interpolation slopes and one static-grid interval
(``filter.propagate.propagate_interval_fast_static``), composed into Phi
and Q; then the extrapolation to the frame time over ``dt_eff``, masked on
dt_eff > 0. Returns ``(X, Phi, Q, lg, la, sg, sa, nprop)``: X with new
Rsb, Tsb and Vsb, Phi and Q (B, 39, 39), the last IMU reading and slopes,
and the intervals propagated (int64). The rotation is not
re-orthonormalized and Phi not OC-corrected: the caller does both.

The op belongs to the filter: its plain version is the filter's
mathematics (``filter.propagate``'s static-grid interval on a
``filter.state.MotionState``), so this module imports the filter layer,
which imports it back only from ``filter.pipeline``.

Dispatch is by the tensors' device alone. A CPU tensor takes the plain
PyTorch version, ``chain_plain`` (the port's slot loop and segment step,
which the CPU tests hold against the JAX package); a CUDA tensor launches
the hand-written kernel of ``csrc/imu_chain.cu`` once, counted on
``CHAIN``, or raises. ``chain_plain`` also serves ``fast_substeps = 0``
(the capped loop, ``propagate_interval_fast``) on either device. The slot
loop is the ``imu_slots`` span and the segment the ``visual_segment``
span; on the card the launch is the ``imu_slots`` span.
"""
from __future__ import annotations

import ctypes

import torch

from .. import tracing
from ..filter import layout as L
from ..filter.config import VIOConfig
from ..filter.propagate import propagate_interval_fast_static
from ..filter.state import MotionState, where_state
from ..geom.so3 import _EPS
from . import _build


# ---------------------------------------------------------------------------
# plain version (CPU path; the yardstick the kernel is checked against)
# ---------------------------------------------------------------------------

def chain_plain(cfg: VIOConfig, X: MotionState, lg, la, sg, sa, imu_gyro,
                imu_accel, imu_dt, dt_eff,
                interval=propagate_interval_fast_static):
    """The chain as a Python loop of PyTorch ops: ``interval`` integrates
    one interval (the static grid, or ``propagate_interval_fast`` at
    ``fast_substeps = 0``)."""
    m = L.MOTION
    dtype, dev = lg.dtype, lg.device
    B = lg.shape[0]
    eye = torch.eye(m, dtype=dtype, device=dev)

    Phi = eye.expand(B, m, m)
    Q = torch.zeros((B, m, m), dtype=dtype, device=dev)
    nprop = torch.zeros((B,), dtype=torch.int64, device=dev)

    def step(X, Phi, Q, lg, la, sgn, san, dti):
        Xn, Phi_i, Qi = interval(cfg, X, lg, la, sgn, san, dti)
        return (Xn, Phi_i @ Phi,
                Phi_i @ Q @ Phi_i.transpose(-1, -2) + Qi)

    with tracing.span(tracing.IMU_SLOTS):
        for k in range(imu_dt.shape[1]):
            gy, ac, dti = imu_gyro[:, k], imu_accel[:, k], imu_dt[:, k]
            dts = torch.clamp(dti, min=1e-12)[:, None]
            sgn, san = (gy - lg) / dts, (ac - la) / dts
            new = step(X, Phi, Q, lg, la, sgn, san, dti) + (
                gy, ac, sgn.to(dtype), san.to(dtype), nprop + 1)
            (X, Phi, Q, lg, la, sg, sa, nprop) = where_state(
                dti > 0, new, (X, Phi, Q, lg, la, sg, sa, nprop))

    # visual-frame extrapolation segment
    with tracing.span(tracing.VISUAL_SEGMENT):
        vis = step(X, Phi, Q, lg, la, sg, sa, dt_eff) + (
            lg + sg * dt_eff[:, None], la + sa * dt_eff[:, None], nprop + 1)
        X, Phi, Q, lg, la, nprop = where_state(dt_eff > 0, vis,
                                               (X, Phi, Q, lg, la, nprop))
    return X, Phi, Q, lg, la, sg, sa, nprop


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

_p, _i = ctypes.c_void_p, ctypes.c_int
LIB = _build.Library(
    "imu_chain",
    {"xivo_imu_chain_f32": [_p, _p, _p, _p, _p, _i, _i, _i, _p, _p],
     "xivo_imu_chain_f64": [_p, _p, _p, _p, _p, _i, _i, _i, _p, _p]})

CHAIN = _build.Kernel("imu_chain")
KERNELS = (CHAIN,)

# csrc/imu_chain.cu's rows. In: these fields of X, lg, la, sg, sa and
# dt_eff, then the KI gyro readings, KI accelerometer readings and KI slot
# lengths. Out: Rsb, Tsb, Vsb, lg, la, sg, sa, of these widths
IN_FIELDS = ("Rsb", "Tsb", "Vsb", "bg", "ba", "Rsg", "Cg", "Ca")
OUT_WIDTHS = (9, 3, 3, 3, 3, 3, 3)


def constants(cfg: VIOConfig):
    """The kernel's 18 constants, in this order: gravity (3), the 12 IMU
    noise densities whose squares are diag Qimu (gyro, accel, gyro bias,
    accel bias), the grid's step h0, the slope floor 1e-12 and so3's
    small-angle switch 1e-8."""
    q = tuple(cfg.Qimu_gyro) + tuple(cfg.Qimu_accel) \
        + tuple(cfg.Qimu_gyro_bias) + tuple(cfg.Qimu_accel_bias)
    return tuple(float(v) for v in tuple(cfg.gravity) + q) \
        + (float(cfg.stepsize), 1e-12, _EPS)


def _check_inputs(cfg, X, lg, la, sg, sa, imu_gyro, imu_accel, imu_dt,
                  dt_eff):
    if cfg.fast_substeps <= 0:
        raise ValueError("the kernel runs the static substep grid: "
                         f"fast_substeps = {cfg.fast_substeps}")
    B, KI = imu_dt.shape[0], imu_dt.shape[-1]
    want = {f: (getattr(X, f), (B, 3, 3) if f[0] in "RC" else (B, 3))
            for f in IN_FIELDS}
    want.update(lg=(lg, (B, 3)), la=(la, (B, 3)), sg=(sg, (B, 3)),
                sa=(sa, (B, 3)), imu_gyro=(imu_gyro, (B, KI, 3)),
                imu_accel=(imu_accel, (B, KI, 3)), imu_dt=(imu_dt, (B, KI)),
                dt_eff=(dt_eff, (B,)))
    dtype, dev = lg.dtype, lg.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"CUDA kernel takes float32 or float64, got {dtype}")
    for name, (v, shape) in want.items():
        if v.dtype != dtype:
            raise TypeError(f"{name}: every input in {dtype}, got {v.dtype}")
        if v.device != dev:
            raise ValueError(f"{name}: every input on {dev}, got "
                             f"{v.device}")
        if tuple(v.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got "
                             f"{tuple(v.shape)}")
    if B == 0:
        raise ValueError("an empty batch launches nothing")


def imu_chain(cfg: VIOConfig, X: MotionState, lg, la, sg, sa, imu_gyro,
              imu_accel, imu_dt, dt_eff):
    """The chain of a frame at ``fast_substeps > 0`` (module docstring):
    on the card one launch of the kernel, counted on ``CHAIN``."""
    if lg.device.type == "cpu":
        return chain_plain(cfg, X, lg, la, sg, sa, imu_gyro, imu_accel,
                           imu_dt, dt_eff)
    with tracing.span(tracing.IMU_SLOTS):
        return _launch(cfg, X, lg, la, sg, sa, imu_gyro, imu_accel, imu_dt,
                       dt_eff)


def _launch(cfg: VIOConfig, X: MotionState, lg, la, sg, sa, imu_gyro,
            imu_accel, imu_dt, dt_eff):
    """One launch of the kernel on CUDA tensors."""
    _check_inputs(cfg, X, lg, la, sg, sa, imu_gyro, imu_accel, imu_dt,
                  dt_eff)
    B, KI = imu_dt.shape
    dtype, dev = lg.dtype, lg.device
    xin = torch.cat(
        [getattr(X, f).reshape(B, -1) for f in IN_FIELDS]
        + [lg, la, sg, sa, dt_eff[:, None], imu_gyro.reshape(B, 3 * KI),
           imu_accel.reshape(B, 3 * KI), imu_dt], dim=1)
    m = L.MOTION
    xout = torch.empty((B, sum(OUT_WIDTHS)), dtype=dtype, device=dev)
    Phi = torch.empty((B, m, m), dtype=dtype, device=dev)
    Q = torch.empty((B, m, m), dtype=dtype, device=dev)
    nprop = torch.empty((B,), dtype=torch.int64, device=dev)
    consts = (ctypes.c_double * 18)(*constants(cfg))
    fn = "xivo_imu_chain_f32" if dtype == torch.float32 \
        else "xivo_imu_chain_f64"
    with torch.cuda.device(dev):
        err = getattr(LIB.get(dev), fn)(
            xin.data_ptr(), xout.data_ptr(), Phi.data_ptr(), Q.data_ptr(),
            nprop.data_ptr(), B, KI, cfg.fast_substeps,
            ctypes.cast(consts, ctypes.c_void_p), _build.stream(lg))
    CHAIN.launched(err)
    R, Tsb, Vsb, lg, la, sg, sa = torch.split(xout, OUT_WIDTHS, dim=1)
    return (X._replace(Rsb=R.view(B, 3, 3), Tsb=Tsb, Vsb=Vsb), Phi, Q, lg,
            la, sg, sa, nprop)
