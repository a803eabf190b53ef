"""B7's plain version (``xivo_tpu_torch/ops/chol.py``) against the JAX
package, on the CPU.

* ``cholesky_batched`` against the reference's ``cholesky_batched`` CPU
  path (``chol_pallas.py:118-124``) in float64, at m = 60 and 228
  (B = 3), with exactly-zero rows and columns: within 1e-12 (two LAPACK
  Cholesky calls on the same input);
* ``cholesky_psd`` on one matrix, on a batch and on a (2, 3, m, m) stack,
  against the reference's ``cholesky_psd`` (its custom vmap rule) the
  same way;
* the plain version against the Pallas kernel body ``_chol_kernel`` run
  with ``interpret=True`` on float32 inputs with an exactly-zero row and
  column: within 1e-5 (float32 sums in the kernel's order against the
  float64 plain version; the inputs are well conditioned, eigenvalues
  >= 0.1, entries O(1)), and the zero row and column exactly zero in
  both;
* the linear-algebra profile (``tools/profile_linalg.py``) runs every
  line at a tiny batch;
* the breakdown tool's cuts (``tools/chol_breakdown.py``), the inversion
  stage of B2 and B3 among them, still match the kernels' source.

The hand-written kernel itself is held against the plain version on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from xivo_tpu.ops import chol_pallas as jcp
from xivo_tpu_torch.ops import chol as tc

torch.set_num_threads(2)
DEAD = (1, 7)


def psd_batch(rng, B, m, dead=DEAD):
    A = rng.standard_normal((B, m, m)) / np.sqrt(m)
    G = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(m)
    G[:, list(dead), :] = 0.0
    G[:, :, list(dead)] = 0.0
    return G


def pallas_interpret(G32, T=128):
    """The reference kernel body ``_chol_kernel`` on (B, m, m) float32,
    padded as ``cholesky_batched`` pads it, in Pallas' interpret mode."""
    B, m, _ = G32.shape
    Dp = max(-(-m // T) * T, 128)
    Gt = jnp.pad(jnp.asarray(G32), ((0, 0), (0, Dp - m), (0, Dp - m)))
    spec = pl.BlockSpec((B, Dp, Dp), lambda i: (i, 0, 0))
    out = pl.pallas_call(
        functools.partial(jcp._chol_kernel, Dp=Dp, T=T, Bc=B),
        out_shape=jax.ShapeDtypeStruct((B, Dp, Dp), jnp.float32),
        grid=(1,), in_specs=[spec], out_specs=spec,
        input_output_aliases={0: 0}, interpret=True)(Gt)
    return np.asarray(out[:, :m, :m])


@pytest.mark.parametrize("m", [60, 228])
def test_plain_matches_reference_cpu_path(m):
    G = psd_batch(np.random.default_rng(m), 3, m)
    Lj = np.asarray(jcp.cholesky_batched(jnp.asarray(G)))
    Lt = tc.cholesky_batched(torch.tensor(G)).numpy()
    np.testing.assert_allclose(Lt, Lj, rtol=0, atol=1e-12)
    assert np.abs(Lt[:, list(DEAD)]).max() == 0.0
    assert np.abs(Lt[:, :, list(DEAD)]).max() == 0.0
    assert np.abs(np.triu(Lt, 1)).max() == 0.0
    np.testing.assert_allclose(Lt @ Lt.transpose(0, 2, 1), G, atol=1e-12)


@pytest.mark.parametrize("shape", [(), (4,), (2, 3)])
def test_cholesky_psd_takes_one_matrix_or_any_batch(shape):
    m = 24
    n = int(np.prod(shape)) if shape else 1
    G = psd_batch(np.random.default_rng(n), n, m).reshape(shape + (m, m))
    if shape:
        fn = jcp.cholesky_psd
        for _ in shape:
            fn = jax.vmap(fn)
        Lj = np.asarray(fn(jnp.asarray(G)))
    else:
        Lj = np.asarray(jcp.cholesky_psd(jnp.asarray(G)))
    Lt = tc.cholesky_psd(torch.tensor(G))
    assert tuple(Lt.shape) == shape + (m, m)
    np.testing.assert_allclose(Lt.numpy(), Lj, rtol=0, atol=1e-12)


@pytest.mark.parametrize("m", [60, 228])
def test_plain_matches_pallas_kernel_body_in_interpret_mode(m):
    G32 = psd_batch(np.random.default_rng(10 + m), 2, m,
                    dead=(m // 3,)).astype(np.float32)
    Lp = pallas_interpret(G32)
    Lt = tc.cholesky_batched(torch.tensor(G32.astype(np.float64))).numpy()
    np.testing.assert_allclose(Lp, Lt, rtol=0, atol=1e-5)
    for L in (Lp, Lt):
        assert np.abs(L[:, m // 3]).max() == 0.0
        assert np.abs(L[:, :, m // 3]).max() == 0.0
        assert np.abs(np.triu(L, 1)).max() == 0.0


def test_plain_version_is_b1s_and_ignores_the_panel_width():
    from xivo_tpu_torch.ops import lanes_chol
    G = torch.tensor(psd_batch(np.random.default_rng(3), 2, 40))
    L = tc.cholesky_batched(G, block=8)
    assert torch.equal(L, lanes_chol.chol_plain(G))
    assert torch.equal(L, tc.cholesky_batched(G, block=32))
    assert tc.CHOL_BLOCKED.launches == 0      # the CPU never launches


def test_profile_linalg_runs_every_line_on_the_cpu():
    """The linear-algebra profile (B7's entry point on the card) at a tiny
    batch on the CPU: every line runs and gives a time (a host time here,
    which says nothing of the card)."""
    from xivo_tpu_torch.tools import profile_linalg
    res = profile_linalg.profile(batch=2, iters=1, device="cpu")
    assert len(res) == 10 and all(ms > 0 for ms in res.values())
    assert {"B7 cholesky_batched(228)", "B7 cholesky_batched(60)",
            "B1 chol_lanes(228)", "torch cholesky_ex(228)"} <= set(res)


def test_breakdown_cuts_each_step_out_of_the_kernel_source():
    """The breakdown tool (``tools/chol_breakdown.py``) times the kernels
    with steps cut from their source: every cut still matches the source
    once, and removes what it names and nothing else; the inversion stage
    of B2 and B3 is a step of its own."""
    from xivo_tpu_torch.tools import chol_breakdown as cb
    full = cb.variant_source("full")
    assert {"trailing", "solve", "block", "store", "load",
            "inverse"} == set(cb.CUTS)
    for step, lines in cb.CUTS.items():
        src = cb.variant_source(step)
        assert len(full) - len(src) == sum(len(line) for line in lines)
    assert "    invert(" in full
    assert "    invert(" not in cb.variant_source("inverse")
    assert len(cb.variant_source("all")) == len(full) - sum(
        len(line) for lines in cb.CUTS.values() for line in lines)
