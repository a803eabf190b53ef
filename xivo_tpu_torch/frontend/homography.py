"""Vectorized homography RANSAC for tracker outlier rejection (port of
``xivo_tpu/frontend/homography.py``).

Replaces cv::findHomography(RANSAC) as used by Tracker::OutlierRejection
(src/tracker.cpp:705-753): hypothesize 4-point DLT homographies in
parallel, score each by its transfer error, and mark the correspondences
outside the best model as outliers.

The reference draws each hypothesis' sample from a JAX key; here the
caller passes the draws, ``uniforms`` (B, n_hyps, N) in [0, 1) (the
runners make them on the device from a seeded ``torch.Generator``; the
tests rebuild the reference's from its key). The sample is the 4 rows of
smallest ``u + 10 * ~valid`` (a stable sort, as ``jnp.argsort``), and the
best hypothesis the first of the largest inlier count.

The DLT. The reference takes the null vector of the 8 x 9 system by SVD,
which PyTorch checks on the host. The port fixes h9 = 1 and solves the
8 x 8 system with ``torch.linalg.solve_ex`` (no host sync), on points
translated to their centroid and scaled to a mean distance of sqrt(2)
(Hartley's normalization, so that the float32 system is not built from
products of raw pixel coordinates), then maps the result back and divides
by H[2, 2] with the reference's 1e-12 clamp. For a sample of rank 8 this
is the reference's ``vt[-1] / H[2, 2]``. A singular sample (3 collinear
points, a repeated point) has no unique homography: the reference takes
one of the SVD's null vectors, the port's LU solve gives entries that
are not finite, whose transfer errors compare false, so that hypothesis
scores 0 inliers.
"""
from __future__ import annotations

import math

import torch

N_HYPS = 64          # hypotheses (the reference's default)


def _normalize(p):
    """Hartley's similarity of each 4-point sample p (..., 4, 2): the
    normalized points, the centroid c (..., 2) and the scale s (...)."""
    c = p.mean(dim=-2)
    d = p - c[..., None, :]
    s = math.sqrt(2.0) / torch.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2).mean(
        dim=-1)
    return d * s[..., None, None], c, s


def _dlt_h(p0, p1):
    """Homographies (..., 3, 3) from 4 correspondences (..., 4, 2)."""
    q0, c0, s0 = _normalize(p0)
    q1, c1, s1 = _normalize(p1)
    x, y, u, v = q0[..., 0], q0[..., 1], q1[..., 0], q1[..., 1]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    # rows [-x -y -1 0 0 0 ux uy] h = -u and [0 0 0 -x -y -1 vx vy] h = -v
    ru = torch.stack([-x, -y, -one, zero, zero, zero, u * x, u * y], -1)
    rv = torch.stack([zero, zero, zero, -x, -y, -one, v * x, v * y], -1)
    A = torch.stack([ru, rv], -2).flatten(-3, -2)            # (..., 8, 8)
    b = torch.stack([-u, -v], -1).flatten(-2)                # (..., 8)
    h, _ = torch.linalg.solve_ex(A, b)
    Hn = torch.cat([h, torch.ones_like(h[..., :1])], -1).unflatten(-1,
                                                                   (3, 3))
    # back to pixels: H = T1^-1 Hn T0, T = [[s, 0, -s cx], [0, s, -s cy],
    # [0, 0, 1]]
    z, o = torch.zeros_like(s0), torch.ones_like(s0)
    T0 = torch.stack([torch.stack([s0, z, -s0 * c0[..., 0]], -1),
                      torch.stack([z, s0, -s0 * c0[..., 1]], -1),
                      torch.stack([z, z, o], -1)], -2)
    T1i = torch.stack([torch.stack([1.0 / s1, z, c1[..., 0]], -1),
                       torch.stack([z, 1.0 / s1, c1[..., 1]], -1),
                       torch.stack([z, z, o], -1)], -2)
    H = T1i @ Hn @ T0
    h22 = H[..., 2, 2]
    h22 = torch.where(torch.abs(h22) < 1e-12, 1e-12, h22)
    return H / h22[..., None, None]


def _transfer_err(H, p0, p1):
    """|H p0 - p1| in pixels: H (..., 3, 3) against every row of p0, p1
    (..., N, 2); the projective divisor clamped to 1e-9 where it is
    smaller in magnitude, as the reference's."""
    x, y = p0[..., 0], p0[..., 1]
    w = [H[..., k, 0, None] * x + H[..., k, 1, None] * y + H[..., k, 2, None]
         for k in range(3)]
    z = torch.where(torch.abs(w[2]) < 1e-9, 1e-9, w[2])
    ex = w[0] / z - p1[..., 0]
    ey = w[1] / z - p1[..., 1]
    return torch.sqrt(ex * ex + ey * ey)


def homography_ransac(uniforms, p0, p1, valid, n_hyps: int = N_HYPS,
                      thresh: float = 3.0, min_inliers: int = 10):
    """Returns (inlier_mask (B, N), ok (B,)) for correspondences p0, p1
    (B, N, 2) whose rows `valid` (B, N) take part; `uniforms` (B, n_hyps,
    N) are the draws. Where the best model has fewer than `min_inliers`
    inliers, nothing is rejected (the mask is `valid`), as the reference
    does when findHomography fails."""
    assert uniforms.shape[-2] == n_hyps, uniforms.shape
    dt = torch.promote_types(p0.dtype, p1.dtype)
    p0, p1 = p0.to(dt), p1.to(dt)
    r = uniforms + (~valid)[..., None, :].to(uniforms.dtype) * 10.0
    idx = torch.sort(r, dim=-1, stable=True).indices[..., :4]  # (B, H, 4)
    b = torch.arange(p0.shape[0], device=p0.device)[:, None, None]
    H = _dlt_h(p0[b, idx], p1[b, idx])                         # (B, H, 3, 3)
    inl = valid[..., None, :] & (_transfer_err(H, p0[:, None],
                                               p1[:, None]) < thresh)
    counts = torch.sum(inl.to(torch.int64), dim=-1)            # (B, H)
    best = torch.argmax(counts, dim=-1)                        # first max
    ok = torch.gather(counts, -1, best[:, None])[:, 0] >= min_inliers
    inl_best = torch.gather(
        inl, 1, best[:, None, None].expand(-1, 1, inl.shape[-1]))[:, 0]
    return torch.where(ok[:, None], inl_best, valid), ok
