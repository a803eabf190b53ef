"""SO(3) calculus on rotation matrices (port of ``xivo_tpu/geom/so3.py``).

Every function broadcasts over leading dimensions and follows the input
dtype and device. Small-angle branches use Taylor switches via
``torch.where`` exactly as the reference does.
"""
from __future__ import annotations

import torch

from ..ops.dense import constant

_EPS = 1e-8


def hat(w):
    """Skew-symmetric matrix such that hat(w) @ v == cross(w, v)."""
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(w0)
    return torch.stack([
        torch.stack([z, -w2, w1], dim=-1),
        torch.stack([w2, z, -w0], dim=-1),
        torch.stack([-w1, w0, z], dim=-1),
    ], dim=-2)


def _eye_like(W):
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def exp(w):
    """Rodrigues: rotation vector -> rotation matrix."""
    t2 = torch.sum(w * w, dim=-1)
    t = torch.sqrt(t2)
    small = t2 < _EPS
    one = torch.ones_like(t)
    a = torch.where(small, 1.0 - t2 / 6.0,
                    torch.sin(t) / torch.where(small, one, t))
    b = torch.where(small, 0.5 - t2 / 24.0,
                    (1.0 - torch.cos(t)) / torch.where(small, one, t2))
    W = hat(w)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def project(R):
    """Re-orthonormalize (two Newton polar iterations)."""
    eye3 = torch.eye(3, dtype=R.dtype, device=R.device)
    for _ in range(2):
        R = R @ (1.5 * eye3 - 0.5 * (R.transpose(-1, -2) @ R))
    return R


def dAB_dA(B, m: int, n: int):
    """d vec_r(A@B) / d vec_r(A) for A (m x n), B (..., n, p) == kron(I_m, B^T)."""
    p = B.shape[-1]
    eye = torch.eye(m, dtype=B.dtype, device=B.device)
    out = torch.einsum("ik,...pn->...ipkn", eye, B.transpose(-1, -2))
    return out.reshape(B.shape[:-2] + (m * p, m * n))


def dAB_dB(A, n: int, p: int):
    """d vec_r(A@B) / d vec_r(B) == kron(A, I_p)."""
    m = A.shape[-2]
    eye = torch.eye(p, dtype=A.dtype, device=A.device)
    out = torch.einsum("...ij,kl->...ikjl", A, eye)
    return out.reshape(A.shape[:-2] + (m * p, n * p))


def dA_dAu(dtype=torch.float32, device=None):
    """d vec_r(A) / d u for 3x3 upper-triangular A with params
    u = (A00, A01, A02, A11, A12, A22)."""
    rows = (0, 1, 2, 4, 5, 8)
    return constant(tuple(tuple(float(r == rows[k]) for k in range(6))
                          for r in range(9)), dtype, device)


def upper_tri_from6(u):
    """(..., 6) -> (..., 3, 3) upper-triangular, the reference Ca layout."""
    z = torch.zeros_like(u[..., 0])
    return torch.stack([
        torch.stack([u[..., 0], u[..., 1], u[..., 2]], dim=-1),
        torch.stack([z, u[..., 3], u[..., 4]], dim=-1),
        torch.stack([z, z, u[..., 5]], dim=-1),
    ], dim=-2)
