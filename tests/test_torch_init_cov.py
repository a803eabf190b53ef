"""The port's correlated-init pass (``xivo_tpu_torch/filter/init_cov.py``)
against the JAX package, on the CPU: the counterparts of
``tests/test_init_cov.py``, and the correlated-init variant of the
recommended accuracy config through ``vio_frame``.

* ``obs_jacobian`` on random geometry against the reference's, and against
  the port's ``compute_jacobian`` with the observing group's pose in place
  of the body pose (the chain it must equal): within 1e-10 and 1e-9;
* ``_jac_blocks_fg`` (all (F, G) pairs of two sequences at once) against
  the reference's, one sequence at a time, and against ``obs_jacobian``
  pair by pair: within 1e-10;
* ``add_init_correlations`` from a shared state (the reference's after
  the 20-frame run below, every occupied slot taken as newly admitted),
  single pass and chunked by 8 and 3: the factor within 1e-10;
* 20 frames of the accuracy config with ``approximate_init_covariance`` on
  the churn world, as ``test_torch_accuracy_pipeline.py`` holds the other
  variants (poses and final state within 1e-8, counts exact, OOS fired);
* chunked against single pass end to end on the port: poses and
  P = S S^T within 1e-9, and different from the run without the pass.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_accuracy_pipeline import (CHURN_STREAM, FRAMES, SEEDS,
                                                accuracy_cfgs,
                                                check_final_state,
                                                check_outputs, run_both)
from xivo_tpu.filter import init_cov as jic
from xivo_tpu.filter.state import MotionState as JaxMotionState
from xivo_tpu.geom import so3 as jso3
from xivo_tpu_torch import interop
from xivo_tpu_torch.filter import init_cov as tic
from xivo_tpu_torch.filter import layout as L
from xivo_tpu_torch.filter.features import compute_jacobian
from xivo_tpu_torch.filter.state import MotionState
from xivo_tpu_torch.runner import batch_states, make_batch_runner
from xivo_tpu_torch.sim.stream import build_pcw_stream

torch.set_num_threads(2)
KIND = 0                                      # pinhole
INTRIN = [275.0, 270.0, 320.0, 240.0, 0, 0, 0, 0, 0]


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def rot(rng, scale):
    return np.asarray(jso3.exp(jnp.asarray(rng.standard_normal(3) * scale)))


def geometry(rng, n):
    """n random (Rbc, Tbc, Rsbr, Tsbr, Rg, Tg, x) draws, stacked."""
    g = [(rot(rng, 0.3), rng.standard_normal(3) * 0.1, rot(rng, 0.5),
          rng.standard_normal(3), rot(rng, 0.2),
          rng.standard_normal(3) * 0.3,
          np.array([rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3),
                    np.log(rng.uniform(1.5, 4.0))])) for _ in range(n)]
    return [np.stack(a) for a in zip(*g)]


def test_obs_jacobian_matches_reference_and_the_measurement_chain():
    Rbc, Tbc, Rsbr, Tsbr, Rg, Tg, x = geometry(np.random.default_rng(7), 10)
    intrin = np.array(INTRIN)
    ref = jax.vmap(lambda *a: jic.obs_jacobian(
        KIND, jnp.asarray(intrin), *a, jnp.float64))(
        *(jnp.asarray(a) for a in (Rbc, Tbc, Rsbr, Tsbr, Rg, Tg, x)))
    got = tic.obs_jacobian(KIND, t64(intrin), t64(Rbc), t64(Tbc), t64(Rsbr),
                           t64(Tsbr), t64(Rg), t64(Tg), t64(x))
    good = got[-1].numpy()
    assert good.sum() >= 5
    np.testing.assert_array_equal(good, np.asarray(ref[-1]))
    for a, b in zip(ref[:-1], got[:-1]):
        np.testing.assert_allclose(b.numpy()[good], np.asarray(a)[good],
                                   rtol=0, atol=1e-10)
    # the chain of compute_jacobian with the group pose as the body pose
    n = x.shape[0]
    z3 = torch.zeros((n, 3), dtype=torch.float64)
    eye = torch.eye(3, dtype=torch.float64).expand(n, 3, 3)
    X = MotionState(Rsb=t64(Rg), Tsb=t64(Tg), Vsb=z3, bg=z3, ba=z3,
                    Rbc=t64(Rbc), Tbc=t64(Tbc), Rsg=eye,
                    td=torch.zeros(n, dtype=torch.float64), Cg=eye, Ca=eye)
    jr = compute_jacobian(KIND, t64(intrin), X, t64(Rsbr), t64(Tsbr),
                          t64(x), torch.zeros((n, 2), dtype=torch.float64),
                          z3, online_camera_calib=True)
    Hx, Hc, Hg, Hr, Hcam, _ = (a.numpy()[good] for a in got)
    pairs = [(Hx, jr.J_feat), (Hc, jr.J_motion[..., L.WBC:L.WBC + 6]),
             (Hg[..., :3], jr.J_motion[..., L.WSB:L.WSB + 3]),
             (Hg[..., 3:], jr.J_motion[..., L.TSB:L.TSB + 3]),
             (Hr, jr.J_group), (Hcam, jr.J_cam)]
    for a, b in pairs:
        np.testing.assert_allclose(a, b.numpy()[good], rtol=0, atol=1e-9)
    assert JaxMotionState._fields == MotionState._fields


def test_jac_blocks_fg_matches_reference_and_pairs():
    rng = np.random.default_rng(11)
    B, F, G = 2, 5, 4
    intrin = np.array([[275.0, 275.0, 320.0, 240.0] + [0.0] * 5] * B)
    Rbc = np.stack([rot(rng, 0.05) @ np.asarray(jso3.exp(jnp.asarray(
        [-1.55, 0.0, 0.0]))) for _ in range(B)])
    Tbc = rng.standard_normal((B, 3)) * 0.02
    Rsbr = np.stack([[rot(rng, 0.2) for _ in range(F)] for _ in range(B)])
    Tsbr = rng.standard_normal((B, F, 3)) * 0.5
    Rg = np.stack([[rot(rng, 0.2) for _ in range(G)] for _ in range(B)])
    Tg = rng.standard_normal((B, G, 3)) * 0.5
    x = np.concatenate([0.2 * rng.standard_normal((B, F, 2)),
                        np.log(rng.uniform(2.0, 6.0, (B, F, 1)))], -1)
    got = tic._jac_blocks_fg(KIND, *(t64(a) for a in (
        intrin, Rbc, Tbc, Rsbr, Tsbr, Rg, Tg, x)))
    assert int(got[-1].sum()) > 0
    for b in range(B):
        ref = jic._jac_blocks_fg(KIND, *(jnp.asarray(a[b]) for a in (
            intrin, Rbc, Tbc, Rsbr, Tsbr, Rg, Tg, x)), jnp.float64)
        for a, g in zip(ref, got):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(a), rtol=0,
                                       atol=1e-10)
    pair = tic.obs_jacobian(
        KIND, t64(intrin)[:, None, None], t64(Rbc)[:, None, None],
        t64(Tbc)[:, None, None], t64(Rsbr)[:, :, None],
        t64(Tsbr)[:, :, None], t64(Rg)[:, None], t64(Tg)[:, None],
        t64(x)[:, :, None])
    for a, g in zip(pair, got):
        np.testing.assert_allclose(g.numpy(), a.numpy(), rtol=0, atol=1e-10)


@pytest.fixture(scope="module")
def init_cov_run():
    jc, tc = accuracy_cfgs(approximate_init_covariance=True)
    return jc, tc, run_both(jc, tc)


def test_init_cov_variant_matches_reference_frame_by_frame(init_cov_run):
    _, _, ((_, jo), (_, to), rows) = init_cov_run
    check_outputs("init_cov", jo, to, rows)


def test_init_cov_variant_final_state_matches_reference(init_cov_run):
    _, _, ((js, _), (ts, _), _) = init_cov_run
    check_final_state("init_cov", js, ts)


@pytest.mark.parametrize("chunk", [0, 8, 3])
def test_add_init_correlations_matches_reference(init_cov_run, chunk):
    _, _, ((js, _), _, _) = init_cov_run
    jc, tc = accuracy_cfgs(approximate_init_covariance=True,
                           init_corr_chunk=chunk)
    ts = interop.state_from_numpy(js, "cpu")
    new = ts.f2row >= 0
    assert int(new.sum(-1).min()) >= 3

    @jax.jit
    @jax.vmap
    def reference(s, m, r):
        return jic.add_init_correlations(jc, s, m, r).P

    Pj = np.asarray(reference(jax.tree.map(jnp.asarray, js),
                              jnp.asarray(new.numpy()),
                              jnp.asarray(ts.f2row.numpy(), jnp.int32)))
    Pt = tic.add_init_correlations(tc, ts, new, ts.f2row).P
    np.testing.assert_allclose(Pt.numpy(), Pj, rtol=0, atol=1e-10)
    assert float((Pt - ts.P).abs().max()) > 1e-6


def _run_port(tc):
    tstreams = [build_pcw_stream(tc, seed=sd, total_time=FRAMES * 0.05,
                                 **CHURN_STREAM) for sd in SEEDS]
    ts = batch_states(tc, len(SEEDS), device="cpu")
    ts = ts._replace(
        last_gyro=t64(np.stack([g["gyro0"] for _, g in tstreams])),
        last_accel=t64(np.stack([g["accel0"] for _, g in tstreams])))
    tfi = type(tstreams[0][0])(*(np.stack(x) for x in
                                 zip(*[f for f, _ in tstreams])))
    s, out = make_batch_runner(tc)(ts, tfi)
    return s.P @ s.P.transpose(-1, -2), out.Tsb


def test_init_corr_chunked_equals_full_end_to_end():
    res = {}
    for chunk in (0, 8, 3):
        _, tc = accuracy_cfgs(approximate_init_covariance=True,
                              init_corr_chunk=chunk)
        res[chunk] = _run_port(tc)
    for chunk in (8, 3):
        for a, b in zip(res[chunk], res[0]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-9, err_msg=str(chunk))
    _, tc = accuracy_cfgs()
    P_off, _ = _run_port(tc)
    assert float((P_off - res[0][0]).abs().max()) > 1e-6
