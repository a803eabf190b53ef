"""Textured synthetic imagery (port of ``xivo_tpu/sim/texture.py``): the
inside of a procedurally textured box ("room") rendered through any of
the camera models (the TUM-VI 512 x 512 equidistant lens included), with
photometric nuisances, for the front end's tests and TUM-VI rehearsals.

Pipeline per frame (host numpy): pixel grid -> unproject through the
camera model (once, ``pixel_rays``: the port's ``cam.models.unproject``
in float64 on the CPU) -> rotate rays into the world -> ray/box-interior
intersection -> multi-octave value noise at the hit point (optionally
stamped with unique binary markers) -> distance shading -> exposure gain
-> optional blur -> sensor noise. Everything after ``pixel_rays`` is the
reference's numpy, copied.
"""
from __future__ import annotations

import numpy as np
import torch


def pixel_rays(kind: int, intrin, w: int, h: int) -> np.ndarray:
    """(h, w, 3) unit ray directions in the CAMERA frame for every pixel
    center, unprojected through the camera model (distortion included).
    Compute once per camera config."""
    from ..cam import models as cam_mod
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    xp = torch.from_numpy(np.stack([xs.ravel(), ys.ravel()], axis=1))
    xn = cam_mod.unproject(kind, torch.as_tensor(
        np.asarray(intrin, np.float64)), xp)
    d = torch.cat([xn, torch.ones_like(xn[:, :1])], dim=1)
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    return d.numpy().reshape(h, w, 3)


def world_for(cfg, **kw) -> "TexturedBoxWorld":
    """A ``TexturedBoxWorld`` seen through a ``VIOConfig``'s camera (its
    model, intrinsics and image size); ``kw`` go to the world."""
    from ..cam import models as cam_mod
    kind, intrin, (rows, cols) = cam_mod.intrinsics_from_vio_cfg(
        cfg, dtype=torch.float64, device="cpu")
    return TexturedBoxWorld(kind, intrin.numpy(), cols, rows, **kw)


def _hash01(ix, iy, iz, seed):
    """Deterministic lattice hash -> [0, 1) (vectorized uint32 mix)."""
    with np.errstate(over="ignore"):
        h = (ix.astype(np.uint32) * np.uint32(374761393)
             + iy.astype(np.uint32) * np.uint32(668265263)
             + iz.astype(np.uint32) * np.uint32(2246822519)
             + np.uint32(seed) * np.uint32(3266489917))
        h ^= h >> np.uint32(13)
        h *= np.uint32(1274126177)
        h ^= h >> np.uint32(16)
    return h.astype(np.float64) / 4294967296.0


def value_noise3(p, seed=0):
    """Trilinear value noise at points p (..., 3) -> [0, 1)."""
    pf = np.floor(p)
    f = p - pf
    f = f * f * (3.0 - 2.0 * f)       # smoothstep
    ix, iy, iz = (pf[..., 0].astype(np.int64), pf[..., 1].astype(np.int64),
                  pf[..., 2].astype(np.int64))
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]

    def h(dx, dy, dz):
        return _hash01(ix + dx, iy + dy, iz + dz, seed)

    c00 = h(0, 0, 0) * (1 - fx) + h(1, 0, 0) * fx
    c10 = h(0, 1, 0) * (1 - fx) + h(1, 1, 0) * fx
    c01 = h(0, 0, 1) * (1 - fx) + h(1, 0, 1) * fx
    c11 = h(0, 1, 1) * (1 - fx) + h(1, 1, 1) * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def fbm3(p, octaves=4, seed=0):
    """Fractal (multi-octave) value noise -> approx [0, 1)."""
    out = np.zeros(p.shape[:-1])
    amp, freq, norm = 1.0, 1.0, 0.0
    for o in range(octaves):
        out += amp * value_noise3(p * freq, seed=seed + o)
        norm += amp
        amp *= 0.55
        freq *= 2.1
    return out / norm


class TexturedBoxWorld:
    """Camera inside an axis-aligned textured box (a TUM-VI-like room).

    half_extents: (3,) box half sizes [m]; texture_scale: lattice cells
    per meter (sets feature size on the walls).
    """

    def __init__(self, kind: int, intrin, w: int, h: int,
                 half_extents=(5.0, 5.0, 3.0), texture_scale=3.0,
                 octaves=4, seed=0, base=60.0, contrast=150.0,
                 markers=False, marker_cell=2.0, marker_frac=0.6,
                 marker_grid=3):
        self.rays = pixel_rays(kind, intrin, w, h)       # (h, w, 3)
        self.half = np.asarray(half_extents, np.float64)
        self.scale = texture_scale
        self.octaves = octaves
        self.seed = seed
        self.base = base
        self.contrast = contrast
        # distinctive-landmark mode: every marker_cell x marker_cell
        # wall tile carries a UNIQUE high-contrast binary patch (hash
        # keyed on wall id + tile index), so revisit descriptors are
        # globally distinguishable — the property procedural fBm texture
        # lacks (round-3 finding: aliased BRIEF under lap-to-lap wander).
        # Square size sets the match tolerance to detection-time
        # quantization: measured revisit match rates at 0.5 s trajectory
        # offset are 13/64 (6x6 grid, ~6 px squares) vs 56/64 (3x3
        # grid, ~20 px squares) — big squares keep BRIEF bits stable
        # under the ~1 px corner re-localization between laps
        self.markers = markers
        self.mcell = float(marker_cell)
        self.mfrac = float(marker_frac)
        self.mgrid = int(marker_grid)

    def hit_points(self, Rsc, Tsc):
        """Ray/box-interior intersection. Returns (points (h,w,3),
        depth (h,w), wall id (h,w) in 0..5) — camera inside the box."""
        d = self.rays @ np.asarray(Rsc).T                 # world dirs
        o = np.asarray(Tsc)
        with np.errstate(divide="ignore"):
            t_axis = (np.sign(d) * self.half[None, None, :] - o) / d
        t_axis = np.where(np.abs(d) < 1e-12, np.inf, t_axis)
        axis = np.argmin(t_axis, axis=-1)
        t = np.take_along_axis(t_axis, axis[..., None], -1)[..., 0]
        sgn = np.take_along_axis(np.sign(d).astype(np.int64),
                                 axis[..., None], -1)[..., 0]
        wall = axis * 2 + (sgn > 0)
        return o + t[..., None] * d, t, wall

    def _stamp_markers(self, tex, p, wall):
        """Overwrite tex (in [0,1]) with the unique binary patch of any
        marker tile the hit point lands in."""
        C, K = self.mcell, self.mgrid
        s = self.mfrac * C
        # per-wall 2D parameterization: the two non-normal coordinates
        ax = wall // 2
        u = np.choose(ax, [p[..., 1], p[..., 0], p[..., 0]])
        v = np.choose(ax, [p[..., 2], p[..., 2], p[..., 1]])
        ci, cj = np.floor(u / C), np.floor(v / C)
        lu, lv = u - ci * C, v - cj * C
        inx = np.abs(lu - C / 2) < s / 2
        iny = np.abs(lv - C / 2) < s / 2
        inpatch = inx & iny
        gx = np.clip(((lu - (C - s) / 2) / s * K).astype(np.int64),
                     0, K - 1)
        gy = np.clip(((lv - (C - s) / 2) / s * K).astype(np.int64),
                     0, K - 1)
        # unique bit per (wall, tile, grid square)
        bit = _hash01(ci.astype(np.int64) * K + gx,
                      cj.astype(np.int64) * K + gy,
                      wall, self.seed + 9173) > 0.5
        return np.where(inpatch, np.where(bit, 0.96, 0.04), tex)

    def render(self, Rsc, Tsc, exposure=1.0, blur_px=0.0, noise_std=0.0,
               rng=None):
        """Render one (h, w) float32 frame at camera pose (Rsc, Tsc)."""
        p, t, wall = self.hit_points(Rsc, Tsc)
        tex = fbm3(p * self.scale, octaves=self.octaves, seed=self.seed)
        if self.markers:
            tex = self._stamp_markers(tex, p, wall)
        # mild distance shading — keeps walls distinguishable and gives
        # the intensity a low-frequency component like real rooms
        shade = 1.0 / (1.0 + 0.06 * t)
        img = (self.base + self.contrast * tex) * shade * exposure
        if blur_px > 0:
            img = _gauss_blur(img, blur_px)
        if noise_std > 0 and rng is not None:
            img = img + rng.standard_normal(img.shape) * noise_std
        return np.clip(img, 0.0, 255.0).astype(np.float32)


def _gauss_blur(img, sigma):
    """Separable Gaussian blur (host-side, small kernel)."""
    r = max(1, int(np.ceil(2.5 * sigma)))
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    pad = np.pad(img, ((r, r), (0, 0)), mode="edge")
    img = sum(pad[i:pad.shape[0] - 2 * r + i] * k[i] for i in range(2 * r + 1))
    pad = np.pad(img, ((0, 0), (r, r)), mode="edge")
    return sum(pad[:, i:pad.shape[1] - 2 * r + i] * k[i]
               for i in range(2 * r + 1))
