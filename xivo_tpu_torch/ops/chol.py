"""Blocked batched Cholesky (port of ``xivo_tpu/ops/chol_pallas.py``).

``cholesky_batched(G)`` -> L for (B, D, D) PSD matrices, and
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
tensor launches the hand-written kernel ``csrc/chol_blocked.cu``; any
other CUDA tensor raises. The same kernel serves ``lanes_chol.chol_lanes``
(B1): ``launch`` counts each call on the name it was made under.

The kernel has one panel width, 16 columns. Its first form was built for
panels of 8, 16 and 32; in the redesigned kernel 8 and 16 time alike on
the H100 and 32 no longer lets two CTAs share an SM at 228 rows, so only
16 is built. ``block`` stays in the signature for the reference's sake
(there a vector-lane width, with no meaning on the GPU) and is ignored by
the kernel and the plain version alike.
"""
from __future__ import annotations

import torch

from . import _build
from .lanes_chol import LIB, _check_input, chol_plain

# the reference's CPU path (see the module docstring)
cholesky_plain = chol_plain


CHOL_BLOCKED = _build.Kernel("chol_blocked")
KERNELS = (CHOL_BLOCKED,)


def cholesky_batched(G: torch.Tensor, block: int = 16):
    """Lower Cholesky of (B, D, D) PSD matrices (masked-pivot contract);
    ``block`` is ignored (see the module docstring)."""
    if G.device.type == "cpu":
        return cholesky_plain(G)
    return launch(G, CHOL_BLOCKED)


def launch(G: torch.Tensor, counter: _build.Kernel) -> torch.Tensor:
    """Launch the kernel on a CUDA tensor, counting on `counter`: B7's
    ``CHOL_BLOCKED`` here, B1's ``lanes_chol.CHOL`` from ``chol_lanes``."""
    _check_input(G)
    B, D, _ = G.shape
    if B == 0 or D == 0:
        raise ValueError(f"expected a non-empty batch, got {tuple(G.shape)}")
    out = torch.empty_like(G)
    with torch.cuda.device(G.device):
        err = LIB.get(G.device).xivo_chol_blocked_f32(
            G.data_ptr(), out.data_ptr(), B, D, _build.stream(G))
    counter.launched(err)
    return out


def cholesky_psd(G: torch.Tensor) -> torch.Tensor:
    """(D, D) or (..., D, D) -> L of the same shape, in one launch."""
    D = G.shape[-1]
    L = cholesky_batched(G.reshape(-1, D, D).contiguous())
    return L.reshape(G.shape)
