"""Batched Cholesky, Cholesky + inverse and triangular inverse: the plain
versions of the program's kernels B1-B3, frozen (a pivot at or below
1e-30 zeroes its column of L and its row of L^-1)."""
from __future__ import annotations

import torch

_FLOOR = 1e-30


# ---------------------------------------------------------------------------
# plain versions (CPU path; the yardstick the kernels are checked against)
# ---------------------------------------------------------------------------

def chol_plain(G):
    """Masked Cholesky: unit pivot on rows whose diagonal is dead,
    re-zeroed after (``_chol_fallback``). Never raises on an indefinite
    input; like the reference it returns NaN there."""
    keep = torch.diagonal(G, dim1=-2, dim2=-1) > _FLOOR
    eye = torch.eye(G.shape[-1], dtype=G.dtype, device=G.device)
    Gm = torch.where(keep[..., :, None] & keep[..., None, :], G, eye)
    L, info = torch.linalg.cholesky_ex(Gm, check_errors=False)
    L = torch.where((info > 0)[..., None, None], torch.nan, L)
    return torch.where(keep[..., :, None], L, 0.0)


def tri_inv_plain(L):
    """Inverse of lower-triangular L with positive or dead diagonal
    (``_tri_inv_fallback``): dead rows of the inverse are zero."""
    keep = torch.diagonal(L, dim1=-2, dim2=-1) > _FLOOR
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    Lm = torch.where(keep[..., :, None] & keep[..., None, :], L, eye)
    inv = torch.linalg.solve_triangular(Lm, eye.expand(L.shape), upper=False)
    return torch.where(keep[..., :, None], inv, 0.0)


def chol_inv_plain(G):
    L = chol_plain(G)
    return L, tri_inv_plain(L)


chol_lanes = chol_plain
chol_inv_lanes = chol_inv_plain
tri_inv_lanes = tri_inv_plain
