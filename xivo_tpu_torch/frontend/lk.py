"""Pyramidal Lucas-Kanade tracking over a batched track table (port of
``xivo_tpu/frontend/lk.py``).

Replaces cv::calcOpticalFlowPyrLK as used by Tracker::UpdateLK
(src/tracker.cpp:463-629): coarse-to-fine translation-only LK with a fixed
iteration budget per level, Scharr template gradients, bilinear sampling,
and the same convergence/validity semantics (eps, window, max level,
border check).

Each level crops one (S, S) patch per track from the previous and the
next image (``image.extract_patch``, an index gather, exact, in place of
the reference's ``_extract_patches``; ``image.scharr`` on the patches is
its ``_scharr_patches``), and hands the window sampling and the
Gauss-Newton loop to ``ops/lk.py``: ``sample_templates`` (B4) and
``gn_tracks`` (B5; ``window_plain`` is the reference's
``_patch_bilinear``). There is one path: its inputs are built as the
reference's kernel branch builds them (``lk.py:175-187``), with the
iterate in patch coordinates; a CPU tensor takes the kernels' plain
versions, a CUDA float32 tensor the kernels.

Shapes: images (B, H, W), points (B, N, 2), masks (B, N).
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from ..ops import lk as lk_ops
from .image import extract_patch, scharr


def _track_level(prev_img, next_img, pts_prev, guesses, valid, half: int,
                 pad: int, iters: int, eps: float):
    """One pyramid level of LK for the whole track table.

    Returns (pts (B, N, 2), ok (B, N)): ok = usable gradient AND the
    iterate never had to leave the searchable pad margin around the guess
    (a track whose correspondence lies beyond the patch must fail, not
    return a clamped position).
    """
    dt = prev_img.dtype
    w = 2 * half + 1
    S = w + 2 * pad

    # template patch; gradients computed in-patch (edge-padded: only the
    # 1-px border differs from full-image gradients, and the window never
    # reads it)
    tcx = torch.round(pts_prev[..., 0]).to(torch.int64)
    tcy = torch.round(pts_prev[..., 1]).to(torch.int64)
    tp = extract_patch(prev_img, tcx, tcy, S)
    gxp, gyp = scharr(tp)
    torig = torch.stack([tcx, tcy], dim=-1).to(dt) - S // 2
    tstart = (pts_prev - half) - torig
    T, Gx, Gy = lk_ops.sample_templates(tp, gxp, gyp, tstart, w)

    gxx = torch.sum(Gx * Gx, dim=(-2, -1))
    gxy = torch.sum(Gx * Gy, dim=(-2, -1))
    gyy = torch.sum(Gy * Gy, dim=(-2, -1))
    det = gxx * gyy - gxy * gxy
    ok_grad = det > 1e-6
    det = torch.where(ok_grad, det, 1.0)

    # search patch in the next image, centred on the initial guess
    scx = torch.round(guesses[..., 0]).to(torch.int64)
    scy = torch.round(guesses[..., 1]).to(torch.int64)
    sp = extract_patch(next_img, scx, scy, S)
    sorig = torch.stack([scx, scy], dim=-1).to(dt) - S // 2

    # the iterate keeps the window inside the patch: pt in [half, half +
    # (S - w - 1)] per axis, in patch coordinates
    lo = torch.full_like(gxx, float(half))
    hi = torch.full_like(gxx, float(half + S - w - 1))
    sc = torch.stack([gxx, gxy, gyy, det, lo, lo, hi, hi,
                      torch.full_like(gxx, float(eps) ** 2)], dim=-1)
    pt0 = guesses - sorig
    st0 = torch.stack([(~ok_grad | ~valid).to(dt), torch.zeros_like(gxx)],
                      dim=-1)
    ptp, st = lk_ops.gn_tracks(sp, T, Gx, Gy, sc, pt0, st0, iters)
    return ptp + sorig, ok_grad & ~(st[..., 1] > 0.5)


def track(prev_pyr: List[torch.Tensor], next_pyr: List[torch.Tensor],
          pts, guesses, valid, win_size: int = 15, iters: int = 30,
          eps: float = 0.01, pad: int = 8) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Track points from prev to next through the pyramid.

    pts (B, N, 2) positions in the previous full-resolution image; guesses
    (B, N, 2) initial estimates in the next image (the filter prediction
    hook, cv::OPTFLOW_USE_INITIAL_FLOW). Returns (new_pts (B, N, 2), ok
    (B, N)). ``pad`` bounds the refinement one level may add on top of
    the pyramid guess (the patch margin).
    """
    half = win_size // 2
    L = len(prev_pyr)
    cur = guesses / 2.0 ** (L - 1)
    ok_all = valid
    for lvl in range(L - 1, -1, -1):
        s = 2.0 ** lvl
        new_pts, okg = _track_level(prev_pyr[lvl], next_pyr[lvl], pts / s,
                                    cur, valid, half, pad, iters, eps)
        new_pts = torch.where(valid[..., None], new_pts, cur)
        ok_all = ok_all & okg
        cur = new_pts * 2.0 if lvl > 0 else new_pts

    H, W = next_pyr[0].shape[-2:]
    inb = (cur[..., 0] >= half) & (cur[..., 0] < W - half) \
        & (cur[..., 1] >= half) & (cur[..., 1] < H - half)
    return cur, ok_all & inb & valid
