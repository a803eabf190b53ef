"""The port's hand-written CUDA kernels on the card.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA GPU
with ``nvcc`` and skips without one. The file imports no JAX, so it also
runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version (which the CPU
tests hold against the JAX package) on the same float32 inputs.
Tolerance 1e-4 absolute: well-conditioned inputs (eigenvalues >= 0.1,
entries O(1)), two float32 factorizations summing in another order.
"""
import numpy as np
import pytest
import torch

from xivo_tpu_torch.ops import lanes_chol as lc

pytestmark = pytest.mark.cuda
TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def psd_batch(B, m, dead, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, m, m)) / np.sqrt(m)
    G = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(m)
    G[:, dead, :] = 0.0
    G[:, :, dead] = 0.0
    return torch.tensor(G, dtype=torch.float32, device="cuda")


def close(a, b, tol=TOL):
    torch.cuda.synchronize()
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=0,
                               atol=tol)


def zero_rows_stay_zero(X, dead):
    assert float(X[:, dead, :].abs().max()) == 0.0
    assert float(X[:, :, dead].abs().max()) == 0.0
    assert float(torch.triu(X, 1).abs().max()) == 0.0


@pytest.mark.parametrize("m", [12, 60, 228])
def test_chol_kernel_matches_plain_version(cuda, m):
    dead = [0, m // 3, m - 2]
    G = psd_batch(64, m, dead, seed=m)
    n = lc.CHOL.launches
    L = lc.chol_lanes(G)
    assert lc.CHOL.launches == n + 1
    close(L, lc.chol_plain(G))
    zero_rows_stay_zero(L, dead)


@pytest.mark.parametrize("m", [12, 60, 128])
def test_chol_inv_and_tri_inv_kernels_match_plain_versions(cuda, m):
    dead = [1, m // 2]
    G = psd_batch(64, m, dead, seed=m + 1)
    L, Linv = lc.chol_inv_lanes(G)
    Lp, Linvp = lc.chol_inv_plain(G)
    close(L, Lp)
    close(Linv, Linvp, 1e-3)   # the inverse amplifies by cond(L) <= ~10
    zero_rows_stay_zero(Linv, dead)
    # the downdate's (L + diag sqrt R): positive or dead diagonal
    Lr = (Lp + torch.diag_embed(
        (torch.diagonal(Lp, dim1=-2, dim2=-1) > 0).float())).contiguous()
    T = lc.tri_inv_lanes(Lr)
    close(T, lc.tri_inv_plain(Lr))
    zero_rows_stay_zero(T, dead)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    G = psd_batch(2, 8, [0], seed=0)
    with pytest.raises(TypeError):
        lc.chol_lanes(G.double())
    with pytest.raises(ValueError):
        lc.chol_lanes(G.transpose(1, 2))
    with pytest.raises(RuntimeError):  # two packed 300 x 300 > 227 KB
        lc.chol_inv_lanes(psd_batch(1, 300, [0], seed=0))

