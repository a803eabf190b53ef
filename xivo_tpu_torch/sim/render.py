"""Synthetic image rendering of a point-cloud world (port of
``xivo_tpu/sim/render.py``; host numpy, bit-equal to the reference).

Renders visible landmarks as Gaussian dots on a dark background: enough
structure for FAST to fire on every landmark and for LK to track them,
with exact ground truth.
"""
from __future__ import annotations

import numpy as np


def render_dots(Xs, Rsc, Tsc, K, imw, imh, sigma=1.6, amp=200.0,
                patch=11, background=20.0, rng=None, noise=0.0):
    """Render an (imh, imw) float32 image of world points Xs (N, 3) seen
    by a pinhole camera K at pose (Rsc, Tsc)."""
    img = np.full((imh, imw), background, np.float32)
    Xc = (Xs - Tsc[None, :]) @ Rsc
    z = Xc[:, 2]
    vis = z > 0.1
    xp = np.zeros((len(Xs), 2))
    xp[vis] = Xc[vis, :2] / z[vis, None] \
        * np.array([K[0, 0], K[1, 1]]) + np.array([K[0, 2], K[1, 2]])
    half = patch // 2
    r = np.arange(-half, half + 1)
    oy, ox = np.meshgrid(r, r, indexing="ij")
    for i in np.nonzero(vis)[0]:
        cx, cy = xp[i]
        if not (half <= cx < imw - half - 1 and half <= cy < imh - half - 1):
            continue
        ix, iy = int(round(cx)), int(round(cy))
        fx, fy = cx - ix, cy - iy
        g = amp * np.exp(-((ox - fx) ** 2 + (oy - fy) ** 2)
                         / (2 * sigma ** 2))
        img[iy - half:iy + half + 1, ix - half:ix + half + 1] += g
    if noise > 0 and rng is not None:
        img += rng.standard_normal(img.shape).astype(np.float32) * noise
    return np.clip(img, 0, 255).astype(np.float32)
