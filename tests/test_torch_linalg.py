"""The port's Cholesky kernels' plain versions and square-root covariance
algebra against the JAX package, float64 on the CPU.

On the CPU the JAX lanes kernels take their plain fallback
(``lanes_chol.py:196``), and the port's wrappers take their plain
versions, because the tensors lie on the CPU. Tolerances: 1e-10 absolute
for the factorizations (two LAPACK Cholesky calls on the same input),
1e-9 for the update algebra. The hand-written kernels themselves are
held against these plain versions on the card by
``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xivo_tpu.filter import sqrt_form as jsf
from xivo_tpu.filter.update import joseph_update
from xivo_tpu.ops import lanes_chol as jlc
from xivo_tpu_torch.filter import sqrt_form as tsf
from xivo_tpu_torch.filter.update import measurement_update, mh_distances
from xivo_tpu_torch.ops import lanes_chol as tlc

torch.set_num_threads(2)


def t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=tol)


def psd_batch(rng, B, m, dead):
    A = rng.standard_normal((B, m, m)) / np.sqrt(m)
    G = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(m)
    G[:, dead, :] = 0.0
    G[:, :, dead] = 0.0
    return G


def rand_factor(rng, D, C, zero_rows=()):
    A = rng.standard_normal((D, D)) * 0.3
    S = np.linalg.cholesky(A @ A.T + 0.1 * np.eye(D))
    S[list(zero_rows), :] = 0.0
    S[:, list(zero_rows)] = 0.0
    return np.pad(S, ((0, 0), (0, C)))


@pytest.mark.parametrize("m", [12, 60])
def test_plain_kernels_match_reference_with_zero_rows(m):
    rng = np.random.default_rng(m)
    dead = [1, m // 2, m - 1]
    G = psd_batch(rng, 4, m, dead)
    Lj = np.asarray(jax.vmap(jlc.chol_psd_lanes)(jnp.asarray(G)))
    Lt = tlc.chol_lanes(t(G))
    close(Lt, Lj, 1e-10)
    Lj2, Lij = jax.vmap(jlc.chol_inv_psd_lanes)(jnp.asarray(G))
    Lt2, Lit = tlc.chol_inv_lanes(t(G))
    close(Lt2, Lj2, 1e-10)
    close(Lit, Lij, 1e-9)
    Lr = Lj + np.eye(m)[None] * (np.diagonal(Lj, axis1=1, axis2=2) > 0)[
        :, None, :]
    close(tlc.tri_inv_lanes(t(Lr)), jax.vmap(jlc.tri_inv_psd_lanes)(
        jnp.asarray(Lr)), 1e-10)
    for out in (Lt, Lt2, Lit):
        assert float(out[:, dead, :].abs().max()) == 0.0
        assert float(out[:, :, dead].abs().max()) == 0.0
    assert float(torch.triu(Lit, 1).abs().max()) == 0.0


def test_cuda_wrapper_refuses_what_its_kernel_does_not_take():
    with pytest.raises(TypeError):
        tlc._check_input(torch.zeros((2, 4, 4), dtype=torch.float64))
    with pytest.raises(ValueError):
        tlc._check_input(torch.zeros((2, 4, 4)).transpose(1, 2))
    with pytest.raises(ValueError):
        tlc._check_input(torch.zeros((2, 4, 5)))


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    G = t(psd_batch(np.random.default_rng(3), 2, 6, [2])).float()
    before = [k.launches for k in tlc.KERNELS]
    L = tlc.chol_lanes(G)
    L2, Linv = tlc.chol_inv_lanes(G)
    Rinv = tlc.tri_inv_lanes(L)
    assert [k.launches for k in tlc.KERNELS] == before
    assert torch.equal(L, tlc.chol_plain(G))
    assert torch.equal(L2, L) and torch.equal(Linv, tlc.tri_inv_plain(L))
    assert torch.equal(Rinv, Linv)


def test_factor_recompress_preserves_P_and_zero_rows():
    rng = np.random.default_rng(1)
    D, C = 25, 10
    S = rand_factor(rng, D, C, zero_rows=(4,))
    S[:, D:] = rng.standard_normal((D, C)) * 0.05
    S[4, :] = 0.0
    Qd = np.zeros((39, 39))
    Sj = np.asarray(jsf.factor_recompress(jnp.asarray(S), D))
    St = tsf.factor_recompress(t(S)[None], D)[0]
    close(St, Sj, 1e-10)
    close(tsf.cov_full(St), S @ S.T, 1e-9)
    assert float(St[:, D:].abs().max()) == 0.0
    assert float(St[4].abs().max()) == 0.0
    # the frame's process noise enters the Gram (factor_propagate_absorb)
    D2 = 60
    S2 = rand_factor(rng, D2, 6, zero_rows=(45,))
    A = rng.standard_normal((39, 39)) * 1e-2
    Qd = A @ A.T
    Phi = np.eye(39) + 0.01 * rng.standard_normal((39, 39))

    class Cfg:
        class dims:
            full = D2
    Sj2 = np.asarray(jsf.factor_propagate_absorb(Cfg, jnp.asarray(S2),
                                                 jnp.asarray(Phi),
                                                 jnp.asarray(Qd)))
    St2 = tsf.factor_propagate_absorb(Cfg, t(S2)[None], t(Phi)[None],
                                      t(Qd)[None])[0]
    close(St2, Sj2, 1e-10)
    assert float(St2[45].abs().max()) == 0.0


@pytest.mark.parametrize("m_feat", [6, 108])
def test_sqrt_update_matches_reference_and_joseph(m_feat):
    """m_feat features = 2 m_feat rows: 12 rows is one block, 216 rows the
    chunked path past MAX_DOWNDATE_ROWS."""
    rng = np.random.default_rng(3 + m_feat)
    D, C, F = 40, 12, m_feat
    S = rand_factor(rng, D, C, zero_rows=(7, 23))
    P = S @ S.T
    H = rng.standard_normal((2 * F, D)) * 0.5
    H[:, [7, 23]] = 0.0
    inn = rng.standard_normal(2 * F)
    diagR = np.full(2 * F, 1.3)
    valid = rng.random(F) < 0.7
    ej, Sj = jsf.sqrt_update(jnp.asarray(S), jnp.asarray(H), jnp.asarray(inn),
                             jnp.asarray(diagR),
                             jnp.repeat(jnp.asarray(valid), 2))
    et, St = measurement_update(t(S)[None], t(H)[None], t(inn)[None],
                                t(diagR)[None], torch.tensor(valid)[None])
    close(et[0], ej, 1e-9)
    close(St[0], Sj, 1e-9)
    err_j, P_j = joseph_update(jnp.asarray(P), jnp.asarray(H),
                               jnp.asarray(inn), jnp.asarray(diagR),
                               jnp.asarray(valid))
    close(et[0], err_j, 1e-8)
    close(tsf.cov_full(St[0]), P_j, 1e-8)
    assert float(St[0, 7].abs().max()) == 0.0
    assert float(St[0, 23].abs().max()) == 0.0


def test_innovation_blocks_mh_distances_and_small_cholesky():
    rng = np.random.default_rng(11)
    D, C, F = 35, 9, 5
    S = rand_factor(rng, D, C)
    H = rng.standard_normal((2 * F, D))
    inn = rng.standard_normal(2 * F)
    from xivo_tpu.filter.update import mh_distances as jmh
    close(mh_distances(t(S)[None], t(H)[None], t(inn)[None], 1.7)[0],
          jmh(jnp.asarray(S), jnp.asarray(H), jnp.asarray(inn), 1.7), 1e-9)
    P3 = rng.standard_normal((7, 3, 3))
    P3 = P3 @ P3.transpose(0, 2, 1)
    P3[2] = 0.0
    close(tsf.chol3x3(t(P3)), jsf.chol3x3(jnp.asarray(P3)), 1e-12)
    close(tsf.factor_diag(t(S)), jsf.factor_diag(jnp.asarray(S)), 1e-12)
