"""Batched Cholesky / Cholesky+inverse / triangular inverse (port of
``xivo_tpu/ops/lanes_chol.py``).

Three wrappers, each a hand-written CUDA kernel of
``csrc/chol_blocked.cu``:

* ``chol_lanes(G)``      -> L        replaces ``_chol_lanes_kernel``
  (B1): ``chol_blocked_kernel``, which also serves ``ops/chol.py`` (B7),
  the same function under the same contract
* ``chol_inv_lanes(G)``  -> (L, L^-1) replaces ``_chol_inv_lanes_kernel``
  (B2): ``chol_inv_blocked_kernel``, B1's factorization followed by the
  blocked inversion stage
* ``tri_inv_lanes(L)``   -> L^-1     replaces ``_tri_inv_lanes_kernel``
  (B3): ``tri_inv_blocked_kernel``, a load followed by the same stage

All take (B, m, m) and keep the reference's numerical contract: a pivot
at or below 1e-30 zeroes its column of L (its row of L^-1), so
exactly-zero rows and columns stay exactly zero; upper triangles are zero.

Dispatch is by the tensor's device alone. A CPU tensor takes the plain
PyTorch version beside each kernel (which mirrors the reference's
``_chol_fallback``/``_tri_inv_fallback``); a CUDA tensor launches the
kernel or raises. The kernels are built with ``nvcc`` at the first CUDA
call (never at import) into ``xivo_tpu_torch/_build/`` and loaded with
``ctypes`` (``ops/_build.py``). Each entry is a ``tracing`` span of its
own name.
"""
from __future__ import annotations

import ctypes

import torch

from .. import tracing
from . import _build

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


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

_p, _i = ctypes.c_void_p, ctypes.c_int
# csrc/chol_blocked.cu, also ops/chol.py's (B7)
LIB = _build.Library(
    "chol_blocked",
    {"xivo_chol_blocked_f32": [_p, _p, _i, _i, _p],
     "xivo_chol_inv_f32": [_p, _p, _p, _i, _i, _p],
     "xivo_tri_inv_f32": [_p, _p, _i, _i, _p]},
    init="xivo_chol_blocked_init")  # shared-memory limits, once per device

CHOL = _build.Kernel("chol_lanes")
CHOL_INV = _build.Kernel("chol_inv_lanes")
TRI_INV = _build.Kernel("tri_inv_lanes")
KERNELS = (CHOL, CHOL_INV, TRI_INV)


def _check_input(X):
    if X.dtype != torch.float32:
        raise TypeError(f"CUDA kernel takes float32, got {X.dtype}")
    if X.dim() != 3 or X.shape[-1] != X.shape[-2]:
        raise ValueError(f"expected (B, m, m), got {tuple(X.shape)}")
    if not X.is_contiguous():
        raise ValueError("expected a contiguous tensor")


@tracing.span(tracing.CHOL_LANES)
def chol_lanes(G: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky of (B, m, m) PSD matrices (masked-pivot contract):
    on the card, the blocked kernel of ``csrc/chol_blocked.cu``, counted
    on ``CHOL``."""
    if G.device.type == "cpu":
        return chol_plain(G)
    from . import chol
    return chol.launch(G, CHOL)


@tracing.span(tracing.CHOL_INV_LANES)
def chol_inv_lanes(G: torch.Tensor):
    """(L, L^-1) of (B, m, m) PSD matrices in one launch: L is
    ``chol_lanes``'s, bit for bit."""
    if G.device.type == "cpu":
        return chol_inv_plain(G)
    B, m, _ = G.shape
    _check_input(G)
    L = torch.empty_like(G)
    Linv = torch.empty_like(G)
    with torch.cuda.device(G.device):
        err = LIB.get(G.device).xivo_chol_inv_f32(
            G.data_ptr(), L.data_ptr(), Linv.data_ptr(), B, m,
            _build.stream(G))
    CHOL_INV.launched(err)
    return L, Linv


@tracing.span(tracing.TRI_INV_LANES)
def tri_inv_lanes(L: torch.Tensor) -> torch.Tensor:
    """Inverse of (B, m, m) lower-triangular matrices with positive or dead
    (zero) diagonals; only the lower triangle of L is read."""
    if L.device.type == "cpu":
        return tri_inv_plain(L)
    B, m, _ = L.shape
    _check_input(L)
    out = torch.empty_like(L)
    with torch.cuda.device(L.device):
        err = LIB.get(L.device).xivo_tri_inv_f32(
            L.data_ptr(), out.data_ptr(), B, m, _build.stream(L))
    TRI_INV.launched(err)
    return out
