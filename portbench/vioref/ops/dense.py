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
