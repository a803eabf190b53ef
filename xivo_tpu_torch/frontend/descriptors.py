"""Descriptor options beyond BRIEF: ORB (steered BRIEF), a FREAK-style
retina descriptor and BRISK (port of ``xivo_tpu/frontend/descriptors.py``).

The reference's descriptor factory offers BRIEF/BRISK/ORB/FREAK
(src/tracker.cpp:36-97 via OpenCV); the float family (SIFT/SURF) is out
in both packages. Every extractor here takes pre-smoothed images
img_smooth (B, H, W) and keypoints xy (B, K, 2) and returns (B, K, 8)
int64 words holding 32 bits each, interchangeable with ``brief.hamming``
and ``brief.hamming_matrix``.

* ORB: the patch orientation from the intensity centroid over a disc
  (Rublee et al. 2011 §3.2), then BRIEF's pair pattern rotated by it.
* FREAK-style: 43 retina fields (a center and 7 rings of 6), each the
  mean of its center sample and a 4-point ring at its radius, rotated by
  the centroid orientation; 256 fixed pairs, the longest half first.
* BRISK: 60 points on 4 rings; the long-distance pairs vote the
  orientation (a gradient sum, Leutenegger et al. 2011 eq. 3), the 256
  shortest short-distance pairs give the bits.

The sampling is per keypoint: one patch crop (``image.crop_at``), then
in-patch bilinear samples at the keypoint's own rotated points
(``image.patch_bilinear_points``, which clips them to [0, S - 1.001] as
the reference does). The pattern tables are built by the reference's own
numpy code, so they come out bit for bit equal. The field means are
taken as XLA takes ``jnp.mean`` (the five samples in order, times 1/5);
the sums that feed an orientation (the centroid moments, BRISK's gradient
sum) run in PyTorch's order, not XLA's: the angles agree with the
reference's to rounding, and a bit can flip only where its two samples
are that close.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.dense import constant
from . import brief
from .image import crop_at, patch_bilinear_points

# descriptor kind ids (config ``tracker_cfg.descriptor``)
BRIEF, ORB, FREAK, BRISK = 0, 1, 2, 3
KINDS = {"brief": BRIEF, "orb": ORB, "freak": FREAK, "brisk": BRISK}

ORIENT_PATCH = 2 * 17 + 1     # ``orientation``'s crop
ORB_PATCH = 2 * 23 + 1        # BRIEF radius 15 rotated (21.3) + slack
FREAK_PATCH = 2 * 20 + 1      # retina radius 15 + field size 2 + slack
BRISK_PATCH = 2 * 16 + 1      # pattern radius 10.8 + field ring + slack


def _disc_offsets(radius=15, step=3):
    ys, xs = np.mgrid[-radius:radius + 1:step, -radius:radius + 1:step]
    m = xs ** 2 + ys ** 2 <= radius ** 2
    return np.stack([xs[m], ys[m]], axis=1).astype(np.float32)


_DISC = _disc_offsets()


def _retina(n_rings=7, per_ring=6, r_max=15.0):
    """(43, 3) retina fields: (x, y, field radius)."""
    pts = [(0.0, 0.0, 1.0)]
    for ri in range(n_rings):
        r = r_max * (ri + 1) / n_rings
        size = 0.5 + 1.5 * (ri + 1) / n_rings
        phase = (ri % 2) * np.pi / per_ring
        for k in range(per_ring):
            a = 2 * np.pi * k / per_ring + phase
            pts.append((r * np.cos(a), r * np.sin(a), size))
    return np.asarray(pts, np.float32)


_RETINA = _retina()


def _freak_pairs(n_pairs=256, seed=3):
    """Deterministic coarse-to-fine pair selection over the 43 fields: the
    longest half of all pairs, then a seeded draw from the rest."""
    n = _RETINA.shape[0]
    rng = np.random.default_rng(seed)
    cand = [(i, j) for i in range(n) for j in range(i + 1, n)]
    d = np.asarray([np.hypot(*(_RETINA[i, :2] - _RETINA[j, :2]))
                    for i, j in cand])
    order = np.argsort(-d)          # coarse (long-range) pairs first
    take = list(order[: n_pairs // 2])
    rest = order[n_pairs // 2:]
    take += list(rng.permutation(rest)[: n_pairs - len(take)])
    return np.asarray([cand[k] for k in take], np.int32)


_FREAK_PAIRS = _freak_pairs()
_RING4 = np.asarray(
    [[1.0, 0], [0, 1.0], [-1.0, 0], [0, -1.0]], np.float32)


def _brisk_pattern():
    """(60, 3) sampling points (x, y, sigma): a center and 4 rings at the
    published radii and counts (BRISK paper Fig. 4 proportions)."""
    radii = [0.0, 2.9, 4.9, 7.4, 10.8]
    counts = [1, 10, 14, 15, 20]
    pts = []
    for ring, (r, n) in enumerate(zip(radii, counts)):
        sigma = 0.5 + 0.25 * ring
        phase = (ring % 2) * np.pi / max(n, 1)
        for k in range(n):
            a = 2 * np.pi * k / n + phase
            pts.append((r * np.cos(a), r * np.sin(a), sigma))
    return np.asarray(pts, np.float32)


_BRISK = _brisk_pattern()


def _brisk_pairs():
    """(short pairs (256, 2), long pairs (L, 2)) by the published distance
    thresholds delta_max = 9.75, delta_min = 13.67."""
    n = _BRISK.shape[0]
    cand = [(i, j) for i in range(n) for j in range(i + 1, n)]
    d = np.asarray([np.hypot(*(_BRISK[i, :2] - _BRISK[j, :2]))
                    for i, j in cand])
    short = [cand[k] for k in np.argsort(d) if d[k] < 9.75][:256]
    long_ = [cand[k] for k in range(len(cand)) if d[k] > 13.67]
    return (np.asarray(short, np.int32), np.asarray(long_, np.int32))


_BRISK_SHORT, _BRISK_LONG = _brisk_pairs()
# the long pairs' displacements and their squared lengths, float32 as the
# reference takes them from its float32 pattern
_BRISK_DXY = _BRISK[_BRISK_LONG[:, 1], :2] - _BRISK[_BRISK_LONG[:, 0], :2]
_BRISK_D2 = (_BRISK_DXY[:, 0] * _BRISK_DXY[:, 0]
             + _BRISK_DXY[:, 1] * _BRISK_DXY[:, 1])


def _const(a: np.ndarray, dev, dtype=torch.float32):
    """A pattern table as a shared device constant (``ops/dense.py``)."""
    return constant(tuple(map(tuple, a.tolist())) if a.ndim == 2
                    else tuple(a.tolist()), dtype, dev)


def _pack(bits):
    """(..., 256) bool -> (..., 8) int64 words of 32 bits each."""
    bits = bits.to(torch.int64).reshape(bits.shape[:-1] + (8, 32))
    shifts = torch.arange(32, device=bits.device)
    return torch.sum(bits << shifts, dim=-1)


def _rotate(pts, c, s):
    """Offsets pts (P, 2) rotated by each keypoint's angle (c, s) (B, K):
    ``pts @ R.T`` with R = [[c, -s], [s, c]] -> (B, K, P, 2)."""
    px, py = pts[:, 0], pts[:, 1]
    c, s = c[..., None], s[..., None]
    return torch.stack([px * c + py * (-s), px * s + py * c], dim=-1)


def _orientation_from_patch(patch, center):
    """Intensity-centroid angle (B, K) of patches (B, K, S, S) about the
    keypoints' in-patch positions center (B, K, 2)."""
    offs = _const(_DISC, patch.device)
    vals = patch_bilinear_points(patch, center[..., None, :] + offs)
    m10 = torch.sum(vals * offs[:, 0], dim=-1)
    m01 = torch.sum(vals * offs[:, 1], dim=-1)
    return torch.atan2(m01, m10)


def _crop(img_smooth, xy, S: int):
    """(patches (B, K, S, S), the keypoints' positions in them (B, K, 2))."""
    patch, base = crop_at(img_smooth, xy, S)
    return patch, xy - base


def orientation(img_smooth, xy):
    """Intensity-centroid patch orientation (B, K) (ORB, Rublee et al.
    §3.2) at keypoints xy (B, K, 2)."""
    return _orientation_from_patch(*_crop(img_smooth, xy, ORIENT_PATCH))


def extract_orb(img_smooth, xy):
    """Steered-BRIEF descriptors (B, K, 8): one crop serves the
    orientation disc and the rotated pattern."""
    patch, center = _crop(img_smooth, xy, ORB_PATCH)
    th = _orientation_from_patch(patch, center)
    pat = constant(brief._REL, torch.float32, img_smooth.device)  # (512, 2)
    rel = _rotate(pat, torch.cos(th), torch.sin(th))
    vals = patch_bilinear_points(patch, center[..., None, :] + rel)
    return _pack(vals[..., :brief.N_BITS] < vals[..., brief.N_BITS:])


def _fields(patch, center, pat, c=None, s=None):
    """Receptive-field means (B, K, N): each of the N pattern points
    pat (N, 3) = (x, y, radius), rotated by (c, s) where given, is the
    mean of its center sample and a 4-point ring at its radius."""
    dev = patch.device
    if c is None:
        rel = pat[:, :2].expand(center.shape[:-1] + pat[:, :2].shape)
    else:
        rel = _rotate(pat[:, :2], c, s)
    centers = center[..., None, :] + rel                       # (B, K, N, 2)
    ring = _const(_RING4, dev)
    samp = centers[..., None, :] + ring * pat[:, 2, None, None]
    pts = torch.cat([centers[..., None, :], samp], dim=-2)     # (.., N, 5, 2)
    vals = patch_bilinear_points(patch, pts.flatten(-3, -2)).unflatten(
        -1, (pat.shape[0], 5))
    # the mean as XLA takes it: the five in order, times 1/5
    acc = vals[..., 0]
    for i in range(1, 5):
        acc = acc + vals[..., i]
    return acc * 0.2


def _pair_bits(field, pairs):
    """Words of the comparisons field[i] < field[j] over pairs (256, 2)."""
    return _pack(field[..., pairs[:, 0]] < field[..., pairs[:, 1]])


def extract_freak(img_smooth, xy):
    """FREAK-style retina descriptors (B, K, 8)."""
    dev = img_smooth.device
    patch, center = _crop(img_smooth, xy, FREAK_PATCH)
    th = _orientation_from_patch(patch, center)
    field = _fields(patch, center, _const(_RETINA, dev), torch.cos(th),
                    torch.sin(th))
    return _pair_bits(field, _const(_FREAK_PAIRS, dev, torch.int64))


def extract_brisk(img_smooth, xy):
    """BRISK descriptors (B, K, 8): the orientation from the unrotated
    long pairs' gradient sum, then the short pairs of the rotated
    pattern."""
    dev = img_smooth.device
    patch, center = _crop(img_smooth, xy, BRISK_PATCH)
    pat = _const(_BRISK, dev)
    f0 = _fields(patch, center, pat)
    lp = _const(_BRISK_LONG, dev, torch.int64)
    dI = f0[..., lp[:, 1]] - f0[..., lp[:, 0]]
    w = dI / _const(_BRISK_D2, dev)
    dxy = _const(_BRISK_DXY, dev)
    g = torch.sum(dxy * w[..., None], dim=-2)                  # (B, K, 2)
    th = torch.atan2(g[..., 1], g[..., 0])
    f = _fields(patch, center, pat, torch.cos(th), torch.sin(th))
    return _pair_bits(f, _const(_BRISK_SHORT, dev, torch.int64))


def extract(kind: int, img_smooth, xy):
    """The descriptor factory: words (B, K, 8) of kind ``kind`` (a value of
    ``KINDS``) at keypoints xy (B, K, 2) of the smoothed images."""
    if kind == ORB:
        return extract_orb(img_smooth, xy)
    if kind == FREAK:
        return extract_freak(img_smooth, xy)
    if kind == BRISK:
        return extract_brisk(img_smooth, xy)
    return brief.extract(img_smooth, xy)
