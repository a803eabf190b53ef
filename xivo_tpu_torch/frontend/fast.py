"""FAST-9/16 corner detection, non-maximum suppression and the masked
top-k pick (port of ``xivo_tpu/frontend/fast.py``, FAST only).

Images carry any leading batch dimensions, (..., H, W). Scores are the
reference's exactly: the contiguous-arc tests and the min-over-arc are
taken by doubling (runs of 1, 2, 4, 8, then 9 ring pixels), which gives
the same booleans and the same minima as the reference's 9-term loops,
in 8 operations instead of 256.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .image import pad_edge

# Bresenham circle of radius 3 (x right, y down): OpenCV's FAST-16 ring
CIRCLE = [
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2),
    (-1, -3),
]


def _arc(x, op, arc: int):
    """op-reduction of ``arc`` consecutive ring entries (ring axis 0,
    wrapping), for every start: out[s] = op(x[s], ..., x[s + arc - 1])."""
    run, n = x, 1
    while 2 * n <= arc:
        run = op(run, torch.roll(run, -n, dims=0))
        n *= 2
    if n < arc:        # top up with the last arc - n entries
        rest = x
        for k in range(1, arc - n):
            rest = op(rest, torch.roll(x, -k, dims=0))
        run = op(run, torch.roll(rest, -n, dims=0))
    return run


def fast_score(img, threshold: float = 20.0, arc: int = 9):
    """FAST corner response map (..., H, W): the max over arcs of the
    min-over-arc of |ring - center| where >= ``arc`` contiguous ring
    pixels are all brighter than center + t or all darker than center - t;
    zero for non-corners."""
    H, W = img.shape[-2:]
    p = pad_edge(pad_edge(img, 3, 3, -2), 3, 3, -1)
    rings = torch.stack([p[..., 3 + dy:3 + dy + H, 3 + dx:3 + dx + W]
                         for (dx, dy) in CIRCLE])                # (16, ...)
    diff = rings - img
    brighter = _arc(diff > threshold, torch.logical_and, arc)
    darker = _arc(diff < -threshold, torch.logical_and, arc)
    is_corner = torch.any(brighter, dim=0) | torch.any(darker, dim=0)
    best = torch.clamp(_arc(torch.abs(diff), torch.minimum, arc)
                       .amax(dim=0), min=0.0)
    return torch.where(is_corner, best, 0.0)


def nms3(score):
    """3x3 non-maximum suppression (-inf outside the image)."""
    H, W = score.shape[-2:]
    p = F.pad(score, (1, 1, 1, 1), value=-torch.inf)
    neigh = torch.stack([p[..., 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                         if not (dx == 0 and dy == 0)])
    return torch.where(score >= neigh.amax(dim=0), score, 0.0)


def select_topk(score, k: int, margin: int, occupied_xy, occupied_valid,
                mask_size: int):
    """Top-k corners with a border margin and occupancy suppression
    (Tracker::MaskOut, src/tracker.cpp:760-774): a (2 * (mask_size // 2)
    + 1)^2 box around every valid occupied position is excluded.

    score (B, H, W); occupied_xy (B, N, 2), occupied_valid (B, N). Returns
    (xy (B, k, 2) float32, score (B, k), valid (B, k)). Among equal scores
    the lower flat index comes first, as ``jax.lax.top_k`` orders them.
    """
    B, H, W = score.shape
    dev = score.device
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    ok = (xs >= margin) & (xs < W - margin) & (ys >= margin) \
        & (ys < H - margin)
    score = torch.where(ok, score, 0.0)

    # occupancy image: invalid rows go to the extra row H, then dropped
    half = mask_size // 2
    cx = torch.clamp(occupied_xy[..., 0].to(torch.int64), 0, W - 1)
    cy = torch.clamp(occupied_xy[..., 1].to(torch.int64), 0, H - 1)
    cy = torch.where(occupied_valid, cy, H)
    occ = torch.zeros((B, (H + 1) * W), dtype=torch.float32, device=dev)
    occ = occ.scatter(1, cy * W + cx, 1.0).reshape(B, H + 1, W)[:, None, :H]
    # separable max-dilation to the (2 half + 1)^2 box
    occ = F.max_pool2d(occ, (2 * half + 1, 1), stride=1, padding=(half, 0))
    occ = F.max_pool2d(occ, (1, 2 * half + 1), stride=1, padding=(0, half))
    score = torch.where(occ[:, 0] > 0, 0.0, score)

    vals, idx = torch.sort(score.reshape(B, H * W), dim=-1, descending=True,
                           stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    xy = torch.stack([(idx % W).to(torch.float32),
                      (idx // W).to(torch.float32)], dim=-1)
    return xy, vals, vals > 0.0
