"""Image primitives: pyramids, gradients, patch crops, bilinear sampling
(port of ``xivo_tpu/frontend/image.py``).

Every function takes images with any leading batch dimensions, (..., H,
W), and keeps the reference's arithmetic: the stencils are the same
shifted sums in the same order, edge padding replicates the border.

The reference crops patches with one-hot selection matmuls
(``sel_matmul``/``sel_einsum``), a TPU matrix-unit trick that runs float32
inputs through one bfloat16 pass and so rounds intensities by up to half
a grey level. It is not ported: a crop here indexes with clamped rows and
columns, which is exact. In float64 the reference's matmuls run at full
precision and the two agree; in float32 the port is the exact one.
"""
from __future__ import annotations

from typing import List

import torch


def pad_edge(x, before: int, after: int, dim: int):
    """Replicate the first/last slice of x along ``dim`` (``mode="edge"``)."""
    n = x.shape[dim]
    parts = []
    if before:
        parts.append(x.narrow(dim, 0, 1).expand(
            *x.shape[:dim % x.dim()], before, *x.shape[dim % x.dim() + 1:]))
    parts.append(x)
    if after:
        parts.append(x.narrow(dim, n - 1, 1).expand(
            *x.shape[:dim % x.dim()], after, *x.shape[dim % x.dim() + 1:]))
    return torch.cat(parts, dim=dim)


def _stencil(x, k, dim: int):
    """sum_i x[i : n - len(k) + 1 + i] * k[i] along ``dim`` of the
    edge-padded x, in the reference's order."""
    r = len(k) // 2
    p = pad_edge(x, r, r, dim)
    n = x.shape[dim]
    return sum(p.narrow(dim, i, n) * k[i] for i in range(len(k)))


def blur3(img):
    """3x3 binomial blur (separable [1 2 1]/4)."""
    k = (0.25, 0.5, 0.25)
    return _stencil(_stencil(img, k, -2), k, -1)


def blur5(img):
    """5x5 Gaussian-ish blur (separable [1 4 6 4 1]/16): BRIEF smoothing."""
    k = tuple(v / 16.0 for v in (1.0, 4.0, 6.0, 4.0, 1.0))
    return _stencil(_stencil(img, k, -2), k, -1)


def downsample2(img):
    """Blur + 2x decimation (cv::buildOpticalFlowPyramid level step):
    ((h + 1) // 2, (w + 1) // 2) from (h, w)."""
    return blur3(img)[..., ::2, ::2]


def build_pyramid(img, levels: int) -> List[torch.Tensor]:
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(downsample2(pyr[-1]))
    return pyr


_KD = (-0.5, 0.0, 0.5)            # [-1 0 1] / 2
_KS = (0.1875, 0.625, 0.1875)     # [3 10 3] / 16


def scharr(img):
    """Scharr x/y gradients (the kernel OpenCV LK uses internally) over the
    last two axes, edge-padded."""
    gx = _stencil(_stencil(img, _KS, -2), _KD, -1)
    gy = _stencil(_stencil(img, _KD, -2), _KS, -1)
    return gx, gy


def extract_patch(img, cx, cy, S: int):
    """(..., K, S, S) patches of img (B, H, W) at integer centers cx, cy
    (B, K). Out-of-image rows/cols clamp to the border (replicated edge)."""
    H, W = img.shape[-2:]
    offs = torch.arange(S, device=img.device) - S // 2
    rows = torch.clamp(cy[..., None] + offs, 0, H - 1)          # (B, K, S)
    cols = torch.clamp(cx[..., None] + offs, 0, W - 1)
    b = torch.arange(img.shape[0], device=img.device).reshape(
        (-1,) + (1,) * (cx.dim() + 1))
    return img[b, rows[..., :, None], cols[..., None, :]]


def patch_bilinear_points(patch, pts):
    """Bilinear samples (..., P) of (..., S, S) patches at continuous
    points pts (..., P, 2) = (x, y) in patch coordinates (clipped to
    [0, S - 1.001]); rows are interpolated first, then columns. The
    weights keep the points' dtype, and the sums the wider of the two."""
    S = patch.shape[-1]
    x = torch.clamp(pts[..., 0], 0.0, S - 1.001)
    y = torch.clamp(pts[..., 1], 0.0, S - 1.001)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    ix = x0.to(torch.int64)
    iy = y0.to(torch.int64)
    flat = patch.reshape(patch.shape[:-2] + (S * S,))

    def at(r, c):
        return torch.gather(flat, -1, r * S + c)

    col0 = (1.0 - fy) * at(iy, ix) + fy * at(iy + 1, ix)
    col1 = (1.0 - fy) * at(iy, ix + 1) + fy * at(iy + 1, ix + 1)
    return (1.0 - fx) * col0 + fx * col1


def crop_at(img, xy, S: int):
    """One (S, S) patch crop per keypoint: img (B, H, W), xy (B, K, 2)
    continuous keypoints -> (patches (B, K, S, S), each patch's origin in
    the image (B, K, 2) = round(xy) - S // 2). A point p of the image is
    p - origin in its patch (``patch_bilinear_points``)."""
    cx = torch.round(xy[..., 0]).to(torch.int64)
    cy = torch.round(xy[..., 1]).to(torch.int64)
    patch = extract_patch(img, cx, cy, S)
    return patch, torch.stack([cx, cy], dim=-1).to(img.dtype) - S // 2


def sample_rel(img, xy, rel, S: int):
    """``bilinear(img, xy + rel)`` through one patch crop per keypoint:
    img (B, H, W), xy (B, K, 2) continuous keypoints, rel (P, 2) offsets
    with |rel| <= S // 2 - 1 -> (B, K, P)."""
    patch, base = crop_at(img, xy, S)
    return patch_bilinear_points(patch, (xy[..., None, :] + rel)
                                 - base[..., None, :])
