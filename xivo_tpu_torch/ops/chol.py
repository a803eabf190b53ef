"""Blocked batched Cholesky (port of ``xivo_tpu/ops/chol_pallas.py``).

``cholesky_batched(G, block=32)`` -> L for (B, D, D) PSD matrices, and
``cholesky_psd(G)`` for (D, D) or (..., D, D): the whole batch goes to
ONE launch, as the reference's custom vmap rule sends it to one
``pallas_call`` (``chol_pallas.py:163-168``). Both keep B1's numerical
contract: a pivot at or below 1e-30 zeroes its column, so exactly-zero
rows and columns stay exactly zero, and the upper triangle is zero.

Dispatch is by the tensor's device alone. A CPU tensor takes the plain
version, ``cholesky_plain``: the reference's CPU path
(``chol_pallas.py:118-124``: a unit diagonal on empty rows, a Cholesky,
then re-zero), which is ``lanes_chol.chol_plain``. (The reference's CPU
path keeps a row whose diagonal is above 0, the kernels one whose pivot is
above 1e-30; the plain version takes the kernels' floor.) A float32 CUDA
tensor launches the hand-written kernel ``csrc/chol_blocked.cu`` (B7); any
other CUDA tensor raises.

``block`` is the kernel's panel width: 8, 16 or 32 (one warp factors a
panel's diagonal block, so at most 32). The default, 16, is the fastest
of the three at both of the profile's widths on the H100, where 32 also
spills registers (``chip_smoke.py`` phase 15 times all three; PERF.md).
The TPU kernel's ``block`` (128) was a vector-lane width with no meaning
on the GPU; the keyword is kept for the signature's sake and chooses the
panel instead. The plain version ignores it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .lanes_chol import _check_input, chol_plain

PANELS = (8, 16, 32)
DEFAULT_BLOCK = 16


# the reference's CPU path (see the module docstring)
cholesky_plain = chol_plain


_p, _i = ctypes.c_void_p, ctypes.c_int
_LIB = _build.Library(
    "chol_blocked", {"xivo_chol_blocked_f32": [_p, _p, _i, _i, _i, _p]},
    init="xivo_chol_blocked_init")

CHOL_BLOCKED = _build.Kernel("chol_blocked")
KERNELS = (CHOL_BLOCKED,)


def cholesky_batched(G: torch.Tensor, block: int = DEFAULT_BLOCK):
    """Lower Cholesky of (B, D, D) PSD matrices (masked-pivot contract)."""
    if G.device.type == "cpu":
        return cholesky_plain(G)
    _check_input(G)
    if block not in PANELS:
        raise ValueError(f"block {block}: the kernel's panel width is one "
                         f"of {PANELS}")
    B, D, _ = G.shape
    if B == 0 or D == 0:
        raise ValueError(f"expected a non-empty batch, got {tuple(G.shape)}")
    out = torch.empty_like(G)
    with torch.cuda.device(G.device):
        err = _LIB.get(G.device).xivo_chol_blocked_f32(
            G.data_ptr(), out.data_ptr(), B, D, block, _build.stream(G))
    CHOL_BLOCKED.launched(err)
    return out


def cholesky_psd(G: torch.Tensor) -> torch.Tensor:
    """(D, D) or (..., D, D) -> L of the same shape, in one launch."""
    D = G.shape[-1]
    L = cholesky_batched(G.reshape(-1, D, D).contiguous())
    return L.reshape(G.shape)
