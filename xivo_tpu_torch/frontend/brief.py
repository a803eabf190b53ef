"""BRIEF-256 descriptors as 8 packed 32-bit words + Hamming distance
(port of ``xivo_tpu/frontend/brief.py``).

The port's descriptor words are int64 tensors holding 32-bit values
(``FeatureTable.desc``; ``interop`` maps them to and from the reference's
uint32). PyTorch has no population count, so ``hamming`` counts bits with
the usual SWAR steps on each word.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.dense import constant

N_BITS = 256
N_WORDS = 8
PATCH_RADIUS = 15  # BRIEF-32 uses a 31x31 smoothed patch


def _pattern(seed=17):
    """(256, 4) sampling pairs (x1, y1, x2, y2), isotropic Gaussian,
    sigma = patch/5 (Calonder et al.), clipped into the patch; the
    reference's construction, bit for bit."""
    rng = np.random.default_rng(seed)
    sigma = PATCH_RADIUS * 2 / 5.0
    p = rng.normal(0.0, sigma, size=(N_BITS, 4))
    return np.clip(p, -PATCH_RADIUS, PATCH_RADIUS).astype(np.float32)


PATTERN = _pattern()
# the 512 sample offsets: the first points of the pairs, then the second
_REL = tuple(map(tuple, np.concatenate([PATTERN[:, 0:2], PATTERN[:, 2:4]],
                                       axis=0).tolist()))


def extract(img_smooth, xy):
    """Descriptors (B, K, 8) int64 at keypoints xy (B, K, 2) of the
    pre-smoothed images img_smooth (B, H, W): one patch crop per keypoint,
    then in-patch bilinear samples (``image.sample_rel``)."""
    from .image import sample_rel
    rel = constant(_REL, torch.float32, img_smooth.device)       # (512, 2)
    S = 2 * (PATCH_RADIUS + 2) + 1
    vals = sample_rel(img_smooth, xy, rel, S)
    a, b = vals[..., :N_BITS], vals[..., N_BITS:]
    bits = (a < b).to(torch.int64).reshape(a.shape[:-1] + (N_WORDS, 32))
    shifts = torch.arange(32, device=bits.device)
    return torch.sum(bits << shifts, dim=-1)


def popcount32(x):
    """Set bits of each 32-bit value held in an int64 tensor."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101 & 0xFFFFFFFF) >> 24


def hamming(d1, d2):
    """Hamming distance between packed descriptors (..., 8); broadcasts.
    The analogue of FastBrief::distance (src/fastbrief.h:22-42)."""
    return torch.sum(popcount32(torch.bitwise_xor(d1, d2)), dim=-1)


def hamming_matrix(A, B):
    """(..., N, 8) x (..., M, 8) -> (..., N, M) distances."""
    return hamming(A[..., :, None, :], B[..., None, :, :])
