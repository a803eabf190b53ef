"""The pinhole camera over a padded intrinsics vector (port of
``xivo_tpu/cam/models.py``, the one model the benchmark's configurations
use; ``filter/config.py`` refuses the others).

Parameter layout (index into the 9-vector) is the reference's:
  pinhole     : [fx fy cx cy  0  0  0  0  0 ]         DIM = 4

The JAX package differentiates the closed form with ``jax.jacfwd``; the
Jacobians are written out here. Columns past the model's DIM are
exactly 0.

Every function broadcasts over leading dimensions: ``intrin`` is
(..., 9) and must broadcast against ``xc`` (..., 2). ``kind`` is the
model's id, kept in the signatures as the program has it.
"""
from __future__ import annotations

import torch

MAX_INTRINSICS = 9

PINHOLE = 0

MODEL_IDS = {"pinhole": PINHOLE}
MODEL_DIM = {PINHOLE: 4}


def project(kind: int, intrin, xc):
    """Normalized camera coords xc=(X/Z, Y/Z) -> pixel coords (..., 2)."""
    return intrin[..., :2] * xc + intrin[..., 2:4]


def project_with_jac(kind: int, intrin, xc):
    """Returns (xp, dxp_dxc (..., 2, 2), dxp_dintrin (..., 2, 9))."""
    xd0, xd1 = xc[..., 0], xc[..., 1]
    fx, fy = intrin[..., 0], intrin[..., 1]
    xp = torch.stack([fx * xd0 + intrin[..., 2], fy * xd1 + intrin[..., 3]],
                     -1)
    zero = torch.zeros_like(xp[..., 0])
    one = torch.ones_like(zero)
    J = (torch.ones_like(xd0), torch.zeros_like(xd0),
         torch.zeros_like(xd0), torch.ones_like(xd0))
    d_xc = torch.stack([torch.stack([fx * J[0], fx * J[1]], -1),
                        torch.stack([fy * J[2], fy * J[3]], -1)], -2)
    pad = [zero] * (MAX_INTRINSICS - 4)
    d_p = torch.stack([
        torch.stack([xd0 + zero, zero, one, zero] + pad, -1),
        torch.stack([zero, xd1 + zero, zero, one] + pad, -1)], -2)
    return xp, d_xc, d_p


def unproject(kind: int, intrin, xp):
    """Pixel coords -> normalized camera coords."""
    return (xp - intrin[..., 2:4]) / intrin[..., :2]


def intrinsics_from_vio_cfg(cfg, dtype=torch.float64, device=None):
    """(kind, intrinsics vector (9,), (rows, cols)) of a ``VIOConfig``: its
    ``cam_params`` (rows, cols, fx, fy, cx, cy)."""
    rows, cols, fx, fy, cx, cy = cfg.cam_params[:6]
    v = [fx, fy, cx, cy] + [0.0] * (MAX_INTRINSICS - 4)
    return (MODEL_IDS[cfg.cam_model],
            torch.tensor(v, dtype=dtype, device=device),
            (int(rows), int(cols)))
