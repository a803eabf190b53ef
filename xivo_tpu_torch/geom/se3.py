"""SE(3) helpers over (R, T) pairs (port of ``xivo_tpu/geom/se3.py``).

Poses are kept as separate rotation matrices and translation vectors,
never as 4x4 homogeneous matrices, so every composition is a batched
3x3 product and an add. Every function broadcasts over leading
dimensions and follows the input dtype and device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def _mv(A, v):
    return (A @ v.unsqueeze(-1)).squeeze(-1)


class SE3(NamedTuple):
    R: torch.Tensor  # (..., 3, 3)
    T: torch.Tensor  # (..., 3)

    def __mul__(self, other: "SE3") -> "SE3":
        return SE3(self.R @ other.R, _mv(self.R, other.T) + self.T)

    def inverse(self) -> "SE3":
        Rt = self.R.transpose(-1, -2)
        return SE3(Rt, -_mv(Rt, self.T))

    def act(self, X):
        """Apply to points X (..., 3)."""
        return _mv(self.R, X) + self.T


def identity(dtype=torch.float32, device="cpu") -> SE3:
    return SE3(torch.eye(3, dtype=dtype, device=device),
               torch.zeros(3, dtype=dtype, device=device))
