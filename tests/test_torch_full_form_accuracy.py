"""The recommended accuracy config in the full form through the port's
``vio_frame`` against the JAX package, float64 on the CPU, with OOS
measurement compression forced (``accuracy_full_compressed`` of
``test_torch_full_form.py``, whose checks and tolerances these are), the
mapper's two dense branches on a seeded dense P, and the correlated-init
pass (``add_init_correlations``, single pass and chunked) on that run's
dense P."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xivo_tpu_torch import interop
from xivo_tpu_torch.runner import batch_maps

from test_torch_full_form import (RNG, _pair, check_final_state,
                                  check_frames, dense_P, run_case)


@pytest.fixture(scope="module")
def run():
    return run_case("accuracy_full_compressed")


def test_accuracy_full_form_frames_match_reference(run):
    check_frames(run)


def test_accuracy_full_form_final_state_matches_reference(run):
    check_final_state(run)


def test_dense_mapper_branches_match_reference():
    """The mapper's two dense branches: ``close_loop``'s 2x2 gate blocks
    (through ``innovation_blocks``, which the port's close_loop calls) and
    ``retire_features``'s per-feature 3x3 blocks of the dense feature
    block, through the whole ``retire_features`` on a state whose P is a
    seeded dense P."""
    from xivo_tpu.filter.state import init_state as jax_init_state
    from xivo_tpu.map import mapper as jm
    from xivo_tpu_torch.filter import update as tu
    from xivo_tpu_torch.map import mapper as tm
    jc, tc = _pair()
    D, F, n = tc.dims.full, tc.dims.n_features, 2
    P = dense_P(n, D, [3, 4])
    H = RNG.standard_normal((n, 2 * F, D))
    HP = H @ P
    Sf = HP @ H.transpose(0, 2, 1)
    b_t = tu.innovation_blocks(torch.tensor(P), torch.tensor(H))
    for k, (r, c) in enumerate(((0, 0), (0, 1), (1, 1))):
        np.testing.assert_allclose(b_t[k].numpy(), Sf[:, r::2, c::2].diagonal(
            axis1=1, axis2=2), rtol=1e-12, atol=1e-12)

    # retire_features: instate rows read their block of the dense P
    js = jax_init_state(jc)
    NF, NG = js.features.fid.shape[0], js.groups.gid.shape[0]
    rows = []
    for i in range(n):
        fr = js.features
        sind = np.full(NF, -1, np.int32)
        sind[:F] = RNG.permutation(F)
        fr = fr._replace(
            fid=jnp.arange(NF, dtype=jnp.int32),
            ref=jnp.zeros(NF, jnp.int32),
            sind=jnp.asarray(sind),
            x=jnp.asarray(np.c_[RNG.standard_normal((NF, 2)) * 0.1,
                                np.full(NF, 0.7)]),
            Psub=jnp.asarray(dense_P(NF, 3, [])))
        gr = js.groups._replace(gid=js.groups.gid.at[0].set(5))
        rows.append(js._replace(features=fr, groups=gr,
                                P=jnp.asarray(P[i])))
    jsb = jax.tree.map(lambda *v: jnp.stack(v), *rows)
    mask = np.ones((n, NF), bool)
    jms = jm.init_map(64, jnp.float64)
    jout = jax.vmap(lambda s, m: jm.retire_features(jc, s, jms, m))(
        jsb, jnp.asarray(mask))
    ts = interop.state_from_numpy(jax.tree.map(np.asarray, jsb), "cpu")
    tms = batch_maps(64, n, device="cpu", dtype=torch.float64)
    tout = tm.retire_features(tc, ts, tms, torch.tensor(mask))
    for name in ("Xs", "cov", "gid", "valid"):
        a = getattr(tout, name).numpy()
        b = np.asarray(getattr(jout, name))
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-14,
                                   err_msg=name)
    assert np.asarray(jout.valid).sum() == n * NF


@pytest.mark.parametrize("chunk", [0, 3])
def test_dense_init_correlations_match_reference(run, chunk):
    """``add_init_correlations`` on the dense P of the run's final state
    (every occupied slot of sequence 0 taken as newly admitted, none of
    sequence 1), single pass and chunked by 3: within 1e-10 of P's largest
    entry, and sequence 1's P exactly as it was."""
    import dataclasses
    from xivo_tpu.filter import init_cov as jic
    from xivo_tpu_torch.filter import init_cov as tic
    from test_torch_full_form import case_cfgs
    jc, tc, _ = case_cfgs("accuracy_full_compressed")
    over = dict(approximate_init_covariance=True, init_corr_chunk=chunk)
    jc, tc = (dataclasses.replace(jc, **over),
              dataclasses.replace(tc, **over))
    _, _, (js, _), _, _ = run
    ts = interop.state_from_numpy(js, "cpu")
    new = ts.f2row >= 0
    new[1] = False
    assert int(new[0].sum()) >= 3

    @jax.jit
    @jax.vmap
    def reference(s, m, r):
        return jic.add_init_correlations(jc, s, m, r).P

    Pj = np.asarray(reference(jax.tree.map(jnp.asarray, js),
                              jnp.asarray(new.numpy()),
                              jnp.asarray(ts.f2row.numpy(), jnp.int32)))
    Pt = tic.add_init_correlations(tc, ts, new, ts.f2row).P
    assert Pt.shape[-1] == Pt.shape[-2]
    scale = np.abs(Pj).max()
    assert np.abs(Pt.numpy() - Pj).max() <= 1e-10 * scale
    assert float((Pt[0] - ts.P[0]).abs().max()) > 1e-6
    assert torch.equal(Pt[1], ts.P[1])
