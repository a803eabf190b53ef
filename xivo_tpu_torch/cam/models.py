"""Camera models over a padded intrinsics vector (port of
``xivo_tpu/cam/models.py``), pinhole only.

Parameter layout (index into the 9-vector) is the reference's:
``pinhole: [fx fy cx cy 0 0 0 0 0]``. The JAX package differentiates the
closed forms with ``jax.jacfwd``; for the pinhole model the Jacobians are
written out here. Every function broadcasts over leading dimensions:
``intrin`` is (..., 9) and must broadcast against ``xc`` (..., 2).
"""
from __future__ import annotations

import torch

MAX_INTRINSICS = 9

PINHOLE = 0
ATAN = 1
EQUIDISTANT = 2
RADTAN = 3

MODEL_IDS = {"pinhole": PINHOLE, "atan": ATAN, "equi": EQUIDISTANT,
             "equidistant": EQUIDISTANT, "radtan": RADTAN}
MODEL_DIM = {PINHOLE: 4, ATAN: 5, EQUIDISTANT: 8, RADTAN: 9}


def _check(kind: int):
    if kind != PINHOLE:
        raise NotImplementedError(
            "xivo_tpu_torch: only the pinhole camera is ported; the "
            "atan/equidistant/radtan models come with ROADMAP A.12")


def project(kind: int, intrin, xc):
    """Normalized camera coords xc=(X/Z, Y/Z) -> pixel coords (..., 2)."""
    _check(kind)
    return intrin[..., :2] * xc + intrin[..., 2:4]


def project_with_jac(kind: int, intrin, xc):
    """Returns (xp, dxp_dxc (..., 2, 2), dxp_dintrin (..., 2, 9))."""
    xp = project(kind, intrin, xc)
    fx, fy = intrin[..., 0], intrin[..., 1]
    zero = torch.zeros_like(xp[..., 0])
    one = torch.ones_like(zero)
    d_xc = torch.stack([torch.stack([fx + zero, zero], -1),
                        torch.stack([zero, fy + zero], -1)], -2)
    pad = [zero] * (MAX_INTRINSICS - 4)
    d_p = torch.stack([
        torch.stack([xc[..., 0] + zero, zero, one, zero] + pad, -1),
        torch.stack([zero, xc[..., 1] + zero, zero, one] + pad, -1)], -2)
    return xp, d_xc, d_p


def unproject(kind: int, intrin, xp):
    """Pixel coords -> normalized camera coords."""
    _check(kind)
    return (xp - intrin[..., 2:4]) / intrin[..., :2]


def intrinsics_from_cfg(cfg: dict, dtype=torch.float64, device=None):
    """(kind, intrinsics vector (9,), (rows, cols)) from a camera_cfg dict."""
    kind = MODEL_IDS[cfg["model"].lower()]
    _check(kind)
    v = [cfg["fx"], cfg["fy"], cfg["cx"], cfg["cy"]]
    v = v + [0.0] * (MAX_INTRINSICS - len(v))
    return (kind, torch.tensor(v, dtype=dtype, device=device),
            (cfg["rows"], cfg["cols"]))
