"""B2's and B3's plain versions (``xivo_tpu_torch/ops/lanes_chol.py``)
against the TPU kernel bodies, on the CPU.

The Pallas bodies ``_chol_inv_lanes_kernel`` (B2: L and L^-1) and
``_tri_inv_lanes_kernel`` (B3: a triangle's inverse) run with
``interpret=True`` on float32 inputs in their lanes layout (m, m, B), as
``test_torch_chol_blocked.py::pallas_interpret`` runs B7's body; the
port's ``chol_inv_plain`` and ``tri_inv_plain`` take the same inputs in
float64. Inputs: well-conditioned PSD matrices (eigenvalues >= 0.1,
entries O(1)) with exactly-zero rows and columns at a panel edge (rows 1
and 15); for B3, their factor with a unit diagonal at the dead rows set
back to 0 and non-zero junk in the dead rows and columns below the
diagonal (and above it), which both versions must ignore. Tolerance
1e-5: float32 sums in the body's order against the float64 plain
version. The dead rows and columns come out exactly zero in both.

The hand-written kernels (``csrc/chol_blocked.cu``) are held against the
plain versions on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from xivo_tpu.ops import lanes_chol as jlc
from xivo_tpu_torch.ops import lanes_chol as tlc

torch.set_num_threads(2)
B = 4
TOL = 1e-5


def dead_rows(m):
    return [1, min(15, m - 1)]


def psd_batch(rng, m, dead):
    A = rng.standard_normal((B, m, m)) / np.sqrt(m)
    G = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(m)
    G[:, dead, :] = 0.0
    G[:, :, dead] = 0.0
    return G


def pallas_body(kernel, X32, n_out):
    """The Pallas body on (B, m, m) float32 in the lanes layout, in
    interpret mode; outputs back in (B, m, m)."""
    m = X32.shape[-1]
    Xt = jnp.moveaxis(jnp.asarray(X32), 0, -1)
    shape = jax.ShapeDtypeStruct(Xt.shape, jnp.float32)
    outs = pl.pallas_call(
        functools.partial(kernel, m=m),
        out_shape=shape if n_out == 1 else (shape,) * n_out,
        interpret=True)(Xt)
    outs = outs if n_out > 1 else (outs,)
    return [np.moveaxis(np.asarray(o), -1, 0) for o in outs]


def exactly_zero(X, dead):
    assert np.abs(X[:, dead, :]).max() == 0.0
    assert np.abs(X[:, :, dead]).max() == 0.0


@pytest.mark.parametrize("m", [12, 60])
def test_chol_inv_plain_matches_the_pallas_body(m):
    dead = dead_rows(m)
    G = psd_batch(np.random.default_rng(m), m, dead)
    L_raw, invT = pallas_body(jlc._chol_inv_lanes_kernel,
                              G.astype(np.float32), 2)
    Lp = np.tril(L_raw)                     # the upper half is work data
    Linvp = np.swapaxes(invT, -1, -2)       # the body keeps (L^-1)^T
    Lt, Linvt = (x.numpy() for x in tlc.chol_inv_plain(torch.tensor(G)))
    np.testing.assert_allclose(Lp, Lt, rtol=0, atol=TOL)
    np.testing.assert_allclose(Linvp, Linvt, rtol=0, atol=TOL)
    for X in (Lp, Linvp, Lt, Linvt):
        exactly_zero(X, dead)
        assert np.abs(np.triu(X, 1)).max() == 0.0


@pytest.mark.parametrize("m", [12, 60])
def test_tri_inv_plain_matches_the_pallas_body_and_ignores_dead_junk(m):
    dead = dead_rows(m)
    rng = np.random.default_rng(100 + m)
    L = np.linalg.cholesky(psd_batch(rng, m, []))
    L[:, dead, :] = 0.0
    L[:, :, dead] = 0.0
    for d in dead:                          # junk the contract ignores
        L[:, d, :d] = rng.standard_normal((B, d))
        L[:, d + 1:, d] = rng.standard_normal((B, m - d - 1))
    L += np.triu(rng.standard_normal((B, m, m)), 1)
    assert np.abs(np.diagonal(L, axis1=1, axis2=2)[:, dead]).max() == 0.0
    (invT,) = pallas_body(jlc._tri_inv_lanes_kernel, L.astype(np.float32), 1)
    Xp = np.swapaxes(invT, -1, -2)
    Xt = tlc.tri_inv_plain(torch.tensor(L)).numpy()
    np.testing.assert_allclose(Xp, Xt, rtol=0, atol=TOL)
    for X in (Xp, Xt):
        exactly_zero(X, dead)
        assert np.abs(np.triu(X, 1)).max() == 0.0
