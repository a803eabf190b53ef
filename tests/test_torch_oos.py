"""The port's OOS (MSCKF-style) update (``xivo_tpu_torch/filter/oos.py``)
against the JAX package, on the CPU: the counterparts of
``tests/test_oos.py``.

The shared state is the reference's after 12 frames of the recommended
accuracy config on the churn world of ``test_torch_accuracy_pipeline.py``
(6 group slots, OOS first firing at frame 10), carried to the port with
``interop``. Tolerances, float64: 1e-12 for the Householder sweep on
random inputs and 1e-10 for the OOS rows (the same closed forms in
another operation order); 1e-9 for a whole ``oos_update`` (a Cholesky-
based factor downdate of a 108-wide state); trajectories with compression
forced and off within 1e-6, as ``tests/test_oos.py`` holds them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_accuracy_pipeline import (CHURN_STREAM, FRAMES, SEEDS,
                                                accuracy_cfgs,
                                                oos_rows_applied, run_both)
from tests.test_torch_pipeline import _walk
from xivo_tpu.filter import oos as joos
from xivo_tpu_torch import interop
from xivo_tpu_torch.filter import oos as toos
from xivo_tpu_torch.runner import batch_states, make_batch_runner
from xivo_tpu_torch.sim.stream import build_pcw_stream

torch.set_num_threads(2)
CAP = 8


@pytest.fixture(scope="module")
def shared():
    """(reference config, port config, reference state (numpy leaves), the
    same state on the port, candidate rows (B, NF))."""
    jc, tc = accuracy_cfgs()
    (js, _), _, _ = run_both(jc, tc, frames=12)
    ts = interop.state_from_numpy(js, "cpu")
    fr = ts.features
    # every live feature that is not in the state dies here
    cand = (fr.fid >= 0) & (fr.sind < 0)
    return jc, tc, js, ts, cand


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def test_householder_nullspace_matches_reference():
    rng = np.random.default_rng(3)
    B, m, D = 3, 16, 20
    Hf = rng.standard_normal((B, m, 3))
    Hf[:, 9:] = 0.0                                  # masked observations
    Hx = rng.standard_normal((B, m, D))
    inn = rng.standard_normal((B, m))
    Ho_j, inn_j = jax.vmap(joos._householder_nullspace)(
        jnp.asarray(Hf), jnp.asarray(Hx), jnp.asarray(inn))
    Ho_t, inn_t = toos._householder_nullspace(t64(Hf), t64(Hx), t64(inn))
    assert tuple(Ho_t.shape) == (B, m - 3, D)
    np.testing.assert_allclose(Ho_t.numpy(), Ho_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(inn_t.numpy(), inn_j, rtol=0, atol=1e-12)
    # it annihilates the landmark Jacobian itself
    Hf_proj, _ = toos._householder_nullspace(t64(Hf), t64(Hf),
                                             torch.zeros(B, m,
                                                         dtype=torch.float64))
    assert float(Hf_proj.abs().max()) < 1e-12


def _candidate_rows(cand):
    """(B, CAP) rows: the first CAP candidates of each sequence, -1 after."""
    rows = np.full((cand.shape[0], CAP), -1, np.int64)
    for b in range(cand.shape[0]):
        idx = np.nonzero(cand[b].numpy())[0][:CAP - 1]
        rows[b, :len(idx)] = idx
    return rows


@pytest.mark.parametrize("oos_fej", [False, True])
def test_oos_rows_match_reference_and_per_feature_rows(shared, oos_fej):
    _, _, js, ts, cand = shared
    jc, tc = accuracy_cfgs(oos_fej=oos_fej)
    rows = _candidate_rows(cand)
    assert (rows >= 0).sum() >= 6
    ref = jax.vmap(lambda s, r: joos._oos_rows_all(jc, s, r))(
        jax.tree.map(jnp.asarray, js), jnp.asarray(rows, jnp.int32))
    got = toos._oos_rows_all(tc, ts, torch.tensor(rows))
    for name, a, b in zip(("Ho", "inn", "valid"), ref, got):
        if name == "valid":
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        else:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=1e-10, err_msg=name)
    assert int(got[2].sum()) > 0
    for k in range(CAP):                    # the slot-by-slot builder
        one = toos._oos_rows_for_feature(tc, ts, torch.tensor(rows[:, k]))
        for a, b in zip(got, one):
            np.testing.assert_allclose(b.numpy(), a[:, k].numpy(), rtol=0,
                                       atol=1e-10)


@pytest.mark.parametrize("case", ["default", "compressed", "cap_1"])
def test_oos_update_matches_reference_from_a_shared_state(shared, case):
    _, _, js, ts, cand = shared
    over = {"default": {}, "compressed": {"compression_trigger_ratio": 0.5},
            "cap_1": {"oos_feature_cap": 1}}[case]
    jc, tc = accuracy_cfgs(**over)

    @jax.jit
    @jax.vmap
    def reference(s, c):
        return joos.oos_update(jc, s, c)

    js_new, jdrop = jax.tree.map(np.asarray, reference(
        jax.tree.map(jnp.asarray, js), jnp.asarray(cand.numpy())))
    ts_new, tdrop = toos.oos_update(tc, ts, cand)
    np.testing.assert_array_equal(tdrop.numpy(), jdrop)
    for path, d in _walk(interop.state_to_numpy(ts_new), js_new):
        assert d <= 1e-9, (case, path, d)
    # the update did something, and the candidates with enough instate
    # observations beyond the cap are counted
    assert float((ts_new.P - ts.P).abs().max()) > 1e-6
    fr, gr = ts.features, ts.groups
    nobs = (fr.adj & gr.instate[:, None, :]).sum(-1)
    n_cand = (cand & (nobs >= tc.OOS_min_observations)).sum(-1)
    np.testing.assert_array_equal(
        tdrop.numpy(), torch.clamp(n_cand - tc.oos_feature_cap, min=0))
    if case == "cap_1":
        assert int(tdrop.min()) > 0


def test_compression_is_equivalent():
    """Compression is exact for iid R: the trajectory with the trigger
    forced (ratio 0.5, the 96-row stack compressed to D = 108 rows of
    L^T) equals the one without (ratio 10)."""
    res = {}
    for ratio in (0.5, 10.0):
        _, tc = accuracy_cfgs(compression_trigger_ratio=ratio)
        res[ratio] = _run_port(tc)
    (out_c, rows_c), (out_u, rows_u) = res[0.5], res[10.0]
    np.testing.assert_allclose(out_c.Tsb.numpy(), out_u.Tsb.numpy(),
                               rtol=0, atol=1e-6)
    fired = (rows_u > 0).any(axis=1)
    assert fired.sum() >= 4
    # the compressed stack is a different set of rows
    assert (rows_c[fired] != rows_u[fired]).any()


def test_cap_overflow_is_reported():
    """The static oos_feature_cap does not truncate silently: with a cap
    of 1 the candidates beyond it show in StepOutputs.num_oos_dropped."""
    _, tc = accuracy_cfgs(oos_feature_cap=1)
    out, rows = _run_port(tc)
    assert int(out.num_oos_dropped.sum()) > 0
    _, tc = accuracy_cfgs()
    out, _ = _run_port(tc)
    assert int(out.num_oos_dropped.sum()) == 0


def _run_port(tc):
    """The port alone on the churn world: (StepOutputs, OOS rows per
    frame (T, B))."""
    tstreams = [build_pcw_stream(tc, seed=sd, total_time=FRAMES * 0.05,
                                 **CHURN_STREAM) for sd in SEEDS]
    ts = batch_states(tc, len(tstreams), device="cpu")
    dt = ts.P.dtype
    ts = ts._replace(
        last_gyro=torch.tensor(np.stack([g["gyro0"] for _, g in tstreams]),
                               dtype=dt),
        last_accel=torch.tensor(np.stack([g["accel0"] for _, g in tstreams]),
                                dtype=dt))
    tfi = type(tstreams[0][0])(*(np.stack(x) for x in
                                 zip(*[f for f, _ in tstreams])))
    with oos_rows_applied() as rows:
        _, out = make_batch_runner(tc)(ts, tfi)
    return out, np.asarray(rows)
