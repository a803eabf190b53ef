"""Hamming nearest-neighbour search (port of
``xivo_tpu/ops/hamming_pallas.py``).

``hamming_nn(q, desc, valid)`` -> (dist, idx): for every query descriptor
q (B, F, 8) the nearest valid entry of the map desc (B, M, 8), valid
(B, M). Descriptor words are int64 holding 32-bit values. Invalid entries
count as distance ``NO_MATCH`` (10000), ties go to the lowest index, and a
query with no valid entry gets (10000, 0): the contract of the reference's
kernel and of the jnp path it replaces (``hamming_matrix`` + masked
min/argmin). dist and idx are int64 (B, F).

Dispatch is by the tensor's device alone. A CPU tensor takes the plain
PyTorch version below; a CUDA tensor launches the hand-written kernel
(``csrc/hamming.cu``, B6) or raises. The kernel is built with ``nvcc`` at
the first CUDA call (``ops/_build.py``).
"""
from __future__ import annotations

import ctypes

import torch

from ..frontend import brief
from . import _build

NO_MATCH = 10_000
_KEY_INIT = NO_MATCH << 32      # (dist << 32) | idx of "no valid entry"
_PLAIN_BUDGET = 1 << 21         # plain version: (B, F, chunk) entries a step


def hamming_nn_plain(q, desc, valid):
    """The reference's jnp path (``brief.hamming_matrix``, invalid entries
    at NO_MATCH, min and first argmin), taken over chunks of the map so
    that the (B, F, chunk, 8) intermediate stays bounded; a later chunk
    wins only with a strictly smaller distance."""
    B, F, _ = q.shape
    M = desc.shape[1]
    chunk = max(1, _PLAIN_BUDGET // max(1, B * F))
    best_d = torch.full((B, F), NO_MATCH, dtype=torch.int64, device=q.device)
    best_i = torch.zeros((B, F), dtype=torch.int64, device=q.device)
    for m0 in range(0, M, chunk):
        D = brief.hamming_matrix(q, desc[:, m0:m0 + chunk])
        D = torch.where(valid[:, None, m0:m0 + chunk], D, NO_MATCH)
        i = torch.argmin(D, dim=-1)
        dmin = torch.gather(D, -1, i[..., None])[..., 0]
        better = dmin < best_d
        best_d = torch.where(better, dmin, best_d)
        best_i = torch.where(better, i + m0, best_i)
    return best_d, best_i


_p, _i = ctypes.c_void_p, ctypes.c_int
_LIB = _build.Library("hamming",
                      {"xivo_hamming_nn": [_p] * 4 + [_i, _i, _i, _p]})

HAMMING = _build.Kernel("hamming_nn")
KERNELS = (HAMMING,)


def hamming_nn(q, desc, valid):
    """(dist, idx) of each query's nearest valid map entry; see the module
    docstring."""
    if q.device.type == "cpu":
        return hamming_nn_plain(q, desc, valid)
    B, F, W = q.shape
    M = desc.shape[1]
    if W != 8 or tuple(desc.shape) != (B, M, 8) or \
            tuple(valid.shape) != (B, M):
        raise ValueError(f"expected q (B, F, 8), desc (B, M, 8), valid "
                         f"(B, M); got {tuple(q.shape)}, "
                         f"{tuple(desc.shape)}, {tuple(valid.shape)}")
    if q.dtype != torch.int64 or desc.dtype != torch.int64 or \
            valid.dtype != torch.bool:
        raise TypeError("the kernel takes int64 words and a bool mask, got "
                        f"{q.dtype}, {desc.dtype}, {valid.dtype}")
    if not (q.is_contiguous() and desc.is_contiguous()
            and valid.is_contiguous()):
        raise ValueError("the kernel takes contiguous tensors")
    if F == 0 or M == 0 or B * -(-F // 256) > 65535 or B * M * 8 >= 2 ** 62:
        raise ValueError(f"B={B}, F={F}, M={M}: outside the kernel's grid")
    best = torch.full((B, F), _KEY_INIT, dtype=torch.int64, device=q.device)
    with torch.cuda.device(q.device):
        err = _LIB.get(q.device).xivo_hamming_nn(
            q.data_ptr(), desc.data_ptr(), valid.data_ptr(), best.data_ptr(),
            B, F, M, _build.stream(q))
    HAMMING.launched(err)
    return best >> 32, best & 0xFFFFFFFF
