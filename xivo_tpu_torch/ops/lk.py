"""Pyramidal-LK kernels (port of ``xivo_tpu/ops/lk_pallas.py``).

Two wrappers, one hand-written CUDA kernel each (``csrc/lk.cu``):

* ``sample_templates(tp, gxp, gyp, pos, w)`` -> (T, Gx, Gy)
  replaces ``_tmpl_kernel`` (B4): the bilinear w x w windows of the
  template, Gx and Gy patches of each track at one shared position;
* ``gn_tracks(sp, T, Gx, Gy, sc, pt, st, iters)`` -> (pt, st)
  replaces ``_gn_kernel`` (B5): the whole done-masked Gauss-Newton loop
  of one LK pyramid level, per track.

The layout is the JAX package's public one, track-leading: patches
(..., S, S), windows (..., w, w), per-track scalars (..., k). Leading
dimensions (B, N) are flattened to one track axis, so each call site is
one launch. ``sc`` holds gxx, gxy, gyy, det, lo_x, lo_y, hi_x, hi_y and
eps^2; ``pt`` is the iterate (x, y) in patch coordinates and ``st`` the
state (done, escaped) as 0/1 floats, as ``frontend/lk.py`` builds them.

Dispatch is by the tensor's device alone. A CPU tensor takes the plain
PyTorch version beside each kernel; a CUDA tensor launches the kernel or
raises (float32, contiguous). The kernels are built with ``nvcc`` at the
first CUDA call (``ops/_build.py``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

# ---------------------------------------------------------------------------
# plain versions (CPU path; the yardstick the kernels are checked against)
# ---------------------------------------------------------------------------


def window_plain(patch, start, w: int):
    """Bilinear w x w windows (..., w, w) of patches (..., S, S) at the
    continuous top-left corner start (..., 2) = (x, y), clipped to
    [0, S - w - 1 + 0.999]. The weights (1 - f, f) are taken in start's
    dtype and cast to the patch's; rows are interpolated first, then
    columns (the reference's ``_patch_bilinear``, as a 4-tap gather)."""
    S = patch.shape[-1]
    dt = patch.dtype
    sx = torch.clamp(start[..., 0], 0.0, S - w - 1 + 0.999)
    sy = torch.clamp(start[..., 1], 0.0, S - w - 1 + 0.999)
    bx = torch.floor(sx)
    by = torch.floor(sy)
    fx = sx - bx
    fy = sy - by
    lead = patch.shape[:-2]
    ar = torch.arange(w, device=patch.device)
    rows = (by.to(torch.int64)[..., None] + ar)[..., :, None].expand(
        lead + (w, S))
    r0 = torch.gather(patch, -2, rows)
    r1 = torch.gather(patch, -2, rows + 1)
    Pr = (1.0 - fy).to(dt)[..., None, None] * r0 \
        + fy.to(dt)[..., None, None] * r1                       # (..., w, S)
    cols = (bx.to(torch.int64)[..., None] + ar)[..., None, :].expand(
        lead + (w, w))
    q0 = torch.gather(Pr, -1, cols)
    q1 = torch.gather(Pr, -1, cols + 1)
    return (1.0 - fx).to(dt)[..., None, None] * q0 \
        + fx.to(dt)[..., None, None] * q1


def sample_templates_plain(tp, gxp, gyp, pos, w: int):
    return tuple(window_plain(p, pos, w) for p in (tp, gxp, gyp))


def gn_tracks_plain(sp, T, Gx, Gy, sc, pt, st, iters: int):
    """The done-masked GN loop of the reference's jnp path
    (``frontend/lk.py:189-240``), run for the full ``iters`` budget: a
    done track's update is a no-op, so this equals the reference's early
    exit without a host sync. Convergence: ||step|| < eps."""
    w = T.shape[-1]
    half = w // 2
    gxx, gxy, gyy, det = (sc[..., i] for i in range(4))
    lo, hi = sc[..., 4:6], sc[..., 6:8]
    eps = torch.sqrt(sc[..., 8])
    done = st[..., 0] > 0.5
    esc = st[..., 1] > 0.5
    for _ in range(iters):
        r = window_plain(sp, pt - half, w) - T
        bx = torch.sum(Gx * r, dim=(-2, -1))
        by = torch.sum(Gy * r, dim=(-2, -1))
        dx = (gyy * bx - gxy * by) / det
        dy = (gxx * by - gxy * bx) / det
        small = torch.sqrt(dx * dx + dy * dy) < eps
        raw = pt - torch.stack([dx, dy], dim=-1)
        clamped = torch.minimum(torch.maximum(raw, lo), hi)
        hit = torch.any(raw != clamped, dim=-1)
        pt = torch.where(done[..., None], pt, clamped)
        esc = esc | (hit & ~done)
        done = done | small | hit
    return pt, torch.stack([done, esc], dim=-1).to(st.dtype)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

_p, _i = ctypes.c_void_p, ctypes.c_int
_LIB = _build.Library(
    "lk",
    {"xivo_lk_templates_f32": [_p] * 7 + [_i, _i, _i, _p],
     "xivo_lk_gn_f32": [_p] * 9 + [_i, _i, _i, _i, _p]})

TEMPLATES = _build.Kernel("lk_sample_templates")
GN = _build.Kernel("lk_gn_tracks")
KERNELS = (TEMPLATES, GN)

_MAX_WIN = 16    # B5 keeps w * w <= 32 lanes x 8 entries (csrc/lk.cu)


def _check(lead, **tensors):
    for name, (x, tail) in tensors.items():
        if x.dtype != torch.float32:
            raise TypeError(f"CUDA kernel takes float32, got {x.dtype} "
                            f"for {name}")
        if tuple(x.shape) != tuple(lead) + tuple(tail):
            raise ValueError(f"{name}: expected {tuple(lead) + tuple(tail)}"
                             f", got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")


def _sizes(patch, w):
    S = patch.shape[-1]
    if not 1 <= w <= _MAX_WIN or S < w + 1:
        raise ValueError(f"window {w} in patch {S}: the kernel takes "
                         f"w <= {_MAX_WIN} and S >= w + 1")
    lead = patch.shape[:-2]
    M = math.prod(lead)
    if M * S * S >= 2 ** 31:
        raise ValueError(f"{M} tracks of {S} x {S}: the kernels index "
                         "with 32-bit ints")
    return lead, M, S


def sample_templates(tp, gxp, gyp, pos, w: int):
    """T, Gx, Gy (..., w, w): bilinear windows of the patches tp, gxp,
    gyp (..., S, S) at the shared top-left position pos (..., 2)."""
    if tp.device.type == "cpu":
        return sample_templates_plain(tp, gxp, gyp, pos, w)
    lead, M, S = _sizes(tp, w)
    _check(lead, tp=(tp, (S, S)), gxp=(gxp, (S, S)), gyp=(gyp, (S, S)),
           pos=(pos, (2,)))
    out = [torch.empty(lead + (w, w), dtype=tp.dtype, device=tp.device)
           for _ in range(3)]
    with torch.cuda.device(tp.device):
        err = _LIB.get(tp.device).xivo_lk_templates_f32(
            tp.data_ptr(), gxp.data_ptr(), gyp.data_ptr(), pos.data_ptr(),
            *(o.data_ptr() for o in out), M, S, w, _build.stream(tp))
    TEMPLATES.launched(err)
    return tuple(out)


def gn_tracks(sp, T, Gx, Gy, sc, pt, st, iters: int):
    """One LK level's Gauss-Newton loop for every track: search patches
    sp (..., S, S), template windows T, Gx, Gy (..., w, w), scalars sc
    (..., 9), iterate pt and state st (..., 2) -> (pt, st)."""
    if sp.device.type == "cpu":
        return gn_tracks_plain(sp, T, Gx, Gy, sc, pt, st, iters)
    w = T.shape[-1]
    lead, M, S = _sizes(sp, w)
    _check(lead, sp=(sp, (S, S)), T=(T, (w, w)), Gx=(Gx, (w, w)),
           Gy=(Gy, (w, w)), sc=(sc, (9,)), pt=(pt, (2,)), st=(st, (2,)))
    pt_out = torch.empty_like(pt)
    st_out = torch.empty_like(st)
    with torch.cuda.device(sp.device):
        err = _LIB.get(sp.device).xivo_lk_gn_f32(
            sp.data_ptr(), T.data_ptr(), Gx.data_ptr(), Gy.data_ptr(),
            sc.data_ptr(), pt.data_ptr(), st.data_ptr(), pt_out.data_ptr(),
            st_out.data_ptr(), M, S, w, iters, _build.stream(sp))
    GN.launched(err)
    return pt_out, st_out
