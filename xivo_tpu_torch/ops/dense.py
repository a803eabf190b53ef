"""Dense helpers: batched row gathers (port of ``xivo_tpu/ops/dense.py``),
small device constants and the closed-form 3 x 3 adjugate.

The JAX package replaces traced-index gathers with one-hot matmuls to
suit the TPU (``oh_take``). On the GPU a gather is a plain indexed load,
so the port indexes directly; the values are the same exactly.
"""
from __future__ import annotations

import functools

import torch


def take_rows(arr, idx):
    """``arr[b, idx[b, k]]`` for every batch item: arr (B, N, ...), idx
    (B, K) int64 in [0, N) -> (B, K, ...)."""
    b = torch.arange(arr.shape[0], device=arr.device)[:, None]
    return arr[b, idx]


@functools.lru_cache(maxsize=256)
def constant(values: tuple, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """A small constant tensor on ``device``, made once and then shared.

    A fresh ``torch.tensor(values, device="cuda")`` copies from pageable
    host memory, and PyTorch waits for the stream after such a copy: one
    host sync per call. Inside the frame loop the filter takes its
    constants from here instead. Callers must not write into the result.
    """
    return torch.tensor(values, dtype=dtype, device=device)


def adjugate3(A):
    """(adjugate, determinant) of batched 3 x 3 matrices (..., 3, 3), in
    closed form: A^-1 = adj / det where det is not zero."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co = torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1)],
        dim=-2)
    return co, a * co[..., 0, 0] + b * co[..., 1, 0] + c * co[..., 2, 0]
