"""Hamming nearest-neighbour search (port of
``xivo_tpu/ops/hamming_pallas.py``).

``hamming_nn(q, desc, valid, qmask=None)`` -> (dist, idx): for every
query descriptor q (B, F, 8) the nearest valid entry of the map desc
(B, M, 8), valid (B, M). Descriptor words are int64 holding 32-bit
values. Invalid entries count as distance ``NO_MATCH`` (10000), ties go
to the lowest index, and a query with no valid entry gets (10000, 0): the
contract of the reference's kernel and of the jnp path it replaces
(``hamming_matrix`` + masked min/argmin). dist and idx are int64 (B, F).

``qmask`` (B, F) bool, optional: a row where it is False gets (10000, 0)
and is not scored; every other row gets exactly what it gets without the
mask. ``map_insert`` passes its retiring rows, the only ones
whose match it reads.

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
MAX_QUERIES = 1024              # F the kernel takes (kMaxF)
_PLAIN_BUDGET = 1 << 21         # plain version: (B, F, chunk) entries a step


def hamming_nn_plain(q, desc, valid, qmask=None):
    """The reference's jnp path (``brief.hamming_matrix``, invalid entries
    at NO_MATCH, min and first argmin), taken over chunks of the map so
    that the (B, F, chunk, 8) intermediate stays bounded; a later chunk
    wins only with a strictly smaller distance. Rows outside ``qmask``
    are set to (NO_MATCH, 0) afterwards."""
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
    if qmask is not None:
        best_d = torch.where(qmask, best_d, NO_MATCH)
        best_i = torch.where(qmask, best_i, 0)
    return best_d, best_i


_p, _i = ctypes.c_void_p, ctypes.c_int
_LIB = _build.Library("hamming",
                      {"xivo_hamming_nn": [_p] * 6 + [_i, _i, _i, _p]})

HAMMING = _build.Kernel("hamming_nn")
KERNELS = (HAMMING,)


def hamming_nn(q, desc, valid, qmask=None):
    """(dist, idx) of each query's nearest valid map entry; rows outside
    ``qmask`` at (NO_MATCH, 0). See the module docstring."""
    if q.device.type == "cpu":
        return hamming_nn_plain(q, desc, valid, qmask)
    B, F, W = q.shape
    M = desc.shape[1]
    if W != 8 or tuple(desc.shape) != (B, M, 8) or \
            tuple(valid.shape) != (B, M) or \
            (qmask is not None and tuple(qmask.shape) != (B, F)):
        raise ValueError(f"expected q (B, F, 8), desc (B, M, 8), valid "
                         f"(B, M), qmask (B, F); got {tuple(q.shape)}, "
                         f"{tuple(desc.shape)}, {tuple(valid.shape)}, "
                         f"{None if qmask is None else tuple(qmask.shape)}")
    if q.dtype != torch.int64 or desc.dtype != torch.int64 or \
            valid.dtype != torch.bool or \
            (qmask is not None and qmask.dtype != torch.bool):
        raise TypeError("the kernel takes int64 words and bool masks, got "
                        f"{q.dtype}, {desc.dtype}, {valid.dtype}, "
                        f"{None if qmask is None else qmask.dtype}")
    rest = (desc, valid) + (() if qmask is None else (qmask,))
    if any(t.device != q.device for t in rest):
        raise ValueError("the kernel takes tensors on one device")
    if not all(t.is_contiguous() for t in (q,) + rest):
        raise ValueError("the kernel takes contiguous tensors")
    if q.data_ptr() % 16 or desc.data_ptr() % 16:
        raise ValueError("the kernel takes 16-byte aligned words")
    if F == 0 or M == 0 or F > MAX_QUERIES or M >= 2 ** 31 or \
            B * M * 8 >= 2 ** 62:
        raise ValueError(f"B={B}, F={F}, M={M}: outside the kernel's "
                         f"limits (F <= {MAX_QUERIES})")
    dist = torch.empty((B, F), dtype=torch.int64, device=q.device)
    idx = torch.empty((B, F), dtype=torch.int64, device=q.device)
    with torch.cuda.device(q.device):
        err = _LIB.get(q.device).xivo_hamming_nn(
            q.data_ptr(), desc.data_ptr(), valid.data_ptr(),
            None if qmask is None else qmask.data_ptr(), dist.data_ptr(),
            idx.data_ptr(), B, F, M, _build.stream(q))
    HAMMING.launched(err)
    return dist, idx
