"""Camera models over a padded intrinsics vector (port of
``xivo_tpu/cam/models.py``).

Parameter layout (index into the 9-vector) is the reference's:
  pinhole     : [fx fy cx cy  0  0  0  0  0 ]         DIM = 4
  atan        : [fx fy cx cy  w  0  0  0  0 ]         DIM = 5
  equidistant : [fx fy cx cy k0 k1 k2 k3  0 ]         DIM = 8
  radtan      : [fx fy cx cy p1 p2 k1 k2 k3]          DIM = 9

The JAX package differentiates the closed forms with ``jax.jacfwd``; the
Jacobians are written out here. Where a model switches to a constant
branch near the axis (atan: ``r < 1e-4`` or ``|w| < 1e-8``; equidistant:
``r < 1e-8``), ``jacfwd`` differentiates the constant, so the distortion
is the identity there for both Jacobians: ``dxp_dxc = diag(fx, fy)`` and
the distortion columns of ``dxp_dintrin`` are 0. Columns past the
model's DIM are exactly 0.

Every function broadcasts over leading dimensions: ``intrin`` is
(..., 9) and must broadcast against ``xc`` (..., 2).
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


def _radius(x, y):
    return torch.sqrt(x * x + y * y + 1e-20)


def _scaled(x, y, f, df_dr, r, dp):
    """xd = xc f(r) and its Jacobians, given df/dr and df/d(param) for each
    distortion parameter (`dp`), for the radial models."""
    xd0, xd1 = x * f, y * f
    g = df_dr / r
    J = (f + x * x * g, x * y * g, y * x * g, f + y * y * g)
    return xd0, xd1, J, [(x * d, y * d) for d in dp]


def _atan(x, y, p, params):
    # FOV model (Devernay & Faugeras); ref common/camera_atan.h:26-60
    w = p[..., 4]
    r = _radius(x, y)
    t = torch.tan(w * 0.5)
    w2 = 2.0 * t
    a = torch.arctan(w2 * r)
    wr = w * r
    f = a / wr
    singular = (r < 1e-4) | (torch.abs(w) < 1e-8)
    q = 1.0 / (1.0 + (w2 * r) ** 2)
    zero = torch.zeros_like(f)
    f = torch.where(singular, 1.0, f)
    df_dr = torch.where(singular, zero, w2 * q / wr - a * w / (wr * wr))
    dp = []
    if params:
        # d(w2)/dw = 1 + tan^2(w / 2)
        dp = [torch.where(singular, zero,
                          (1.0 + t * t) * r * q / wr - a * r / (wr * wr))]
    return _scaled(x, y, f, df_dr, r, dp)


def _equidistant(x, y, p, params):
    # ref common/camera_equidist.h:28-98
    k0, k1, k2, k3 = p[..., 4], p[..., 5], p[..., 6], p[..., 7]
    r = _radius(x, y)
    th = torch.arctan(r)
    th2 = th * th
    rd = th * (1.0 + th2 * (k0 + th2 * (k1 + th2 * (k2 + th2 * k3))))
    small = r < 1e-8
    zero = torch.zeros_like(rd)
    f = torch.where(small, 1.0, rd / r)
    drd_dth = 1.0 + th2 * (3.0 * k0 + th2 * (5.0 * k1 + th2 * (
        7.0 * k2 + th2 * 9.0 * k3)))
    drd_dr = drd_dth / (1.0 + r * r)
    df_dr = torch.where(small, zero, drd_dr / r - rd / (r * r))
    dp = []
    if params:
        pw = th2
        for _ in range(4):
            dp.append(torch.where(small, zero, th * pw / r))
            pw = pw * th2
    return _scaled(x, y, f, df_dr, r, dp)


def _radtan(x, y, p, params):
    # OpenCV radial-tangential; ref common/camera_radtan.h:21-100
    p1, p2, k1, k2, k3 = (p[..., 4], p[..., 5], p[..., 6], p[..., 7],
                          p[..., 8])
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xy = x * y
    xd0 = x * radial + 2.0 * p1 * xy + p2 * (r2 + 2.0 * x * x)
    xd1 = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * xy
    dR = 2.0 * (k1 + r2 * (2.0 * k2 + r2 * 3.0 * k3))    # d radial / dr2, x2
    J = (radial + x * x * dR + 2.0 * p1 * y + 6.0 * p2 * x,
         xy * dR + 2.0 * p1 * x + 2.0 * p2 * y,
         xy * dR + 2.0 * p1 * x + 2.0 * p2 * y,
         radial + y * y * dR + 6.0 * p1 * y + 2.0 * p2 * x)
    dp = []
    if params:
        r4 = r2 * r2
        dp = [(2.0 * xy, r2 + 2.0 * y * y), (r2 + 2.0 * x * x, 2.0 * xy),
              (x * r2, y * r2), (x * r4, y * r4), (x * r4 * r2, y * r4 * r2)]
    return xd0, xd1, J, dp


_DISTORT = {ATAN: _atan, EQUIDISTANT: _equidistant, RADTAN: _radtan}


def _distort(kind: int, xc, intrin, params=False):
    """(xd0, xd1, dxd/dxc as (J00, J01, J10, J11), [(dxd0, dxd1) for each
    distortion parameter, with `params`])."""
    x, y = xc[..., 0], xc[..., 1]
    if kind == PINHOLE:
        one, zero = torch.ones_like(x), torch.zeros_like(x)
        return x, y, (one, zero, zero, one), []
    return _DISTORT[kind](x, y, intrin, params)


def project(kind: int, intrin, xc):
    """Normalized camera coords xc=(X/Z, Y/Z) -> pixel coords (..., 2)."""
    xd0, xd1, _, _ = _distort(kind, xc, intrin)
    return intrin[..., :2] * torch.stack([xd0, xd1], -1) + intrin[..., 2:4]


def project_with_jac(kind: int, intrin, xc):
    """Returns (xp, dxp_dxc (..., 2, 2), dxp_dintrin (..., 2, 9))."""
    xd0, xd1, J, dp = _distort(kind, xc, intrin, params=True)
    fx, fy = intrin[..., 0], intrin[..., 1]
    xp = torch.stack([fx * xd0 + intrin[..., 2], fy * xd1 + intrin[..., 3]],
                     -1)
    zero = torch.zeros_like(xp[..., 0])
    one = torch.ones_like(zero)
    d_xc = torch.stack([torch.stack([fx * J[0], fx * J[1]], -1),
                        torch.stack([fy * J[2], fy * J[3]], -1)], -2)
    pad = [zero] * (MAX_INTRINSICS - 4 - len(dp))
    d_p = torch.stack([
        torch.stack([xd0 + zero, zero, one, zero]
                    + [fx * a + zero for a, _ in dp] + pad, -1),
        torch.stack([zero, xd1 + zero, zero, one]
                    + [fy * b + zero for _, b in dp] + pad, -1)], -2)
    return xp, d_xc, d_p


def unproject(kind: int, intrin, xp, iters: int = 15):
    """Pixel coords -> normalized camera coords: exactly `iters` Newton
    steps on the distortion (ref camera_radtan.h:103-160), each a
    closed-form 2x2 solve whose determinant is clamped to 1e-12 where it
    is smaller in magnitude, as the reference's."""
    xk = (xp - intrin[..., 2:4]) / intrin[..., :2]
    if kind == PINHOLE:
        return xk
    xc = xk
    for _ in range(iters):
        xd0, xd1, J, _ = _distort(kind, xc, intrin)
        r0, r1 = xd0 - xk[..., 0], xd1 - xk[..., 1]
        det = J[0] * J[3] - J[1] * J[2]
        det = torch.where(torch.abs(det) < 1e-12, 1e-12, det)
        xc = xc - torch.stack([(J[3] * r0 - J[1] * r1) / det,
                               (J[0] * r1 - J[2] * r0) / det], -1)
    return xc


def intrinsics_from_cfg(cfg: dict, dtype=torch.float64, device=None):
    """(kind, intrinsics vector (9,), (rows, cols)) from a camera_cfg dict
    (``CameraManager::Create``'s parameter unpacking,
    ``src/camera_manager.cpp``)."""
    kind = MODEL_IDS[cfg["model"].lower()]
    v = [cfg["fx"], cfg["fy"], cfg["cx"], cfg["cy"]]
    if kind == ATAN:
        v += [cfg.get("w", cfg.get("k0", 0.0))]
    elif kind == EQUIDISTANT:
        v += [cfg[k] for k in ("k0", "k1", "k2", "k3")]
    elif kind == RADTAN:
        v += [cfg.get(k, 0.0) for k in ("p1", "p2", "k1", "k2", "k3")]
    v = v + [0.0] * (MAX_INTRINSICS - len(v))
    return (kind, torch.tensor(v, dtype=dtype, device=device),
            (cfg["rows"], cfg["cols"]))


_EXTRA_KEYS = {"radtan": ("p1", "p2", "k1", "k2", "k3"),
               "equi": ("k0", "k1", "k2", "k3"),
               "equidistant": ("k0", "k1", "k2", "k3"), "atan": ("w",)}


def intrinsics_from_vio_cfg(cfg, dtype=torch.float64, device=None):
    """``intrinsics_from_cfg`` for a ``VIOConfig``: its ``cam_model`` and
    its ``cam_params`` (rows, cols, fx, fy, cx, cy, then the model's
    distortion entries in the order of its parameter layout)."""
    p = cfg.cam_params
    extra = dict(zip(_EXTRA_KEYS.get(cfg.cam_model, ()), p[6:]))
    return intrinsics_from_cfg(
        dict(model=cfg.cam_model, rows=int(p[0]), cols=int(p[1]), fx=p[2],
             fy=p[3], cx=p[4], cy=p[5], **extra), dtype=dtype, device=device)
