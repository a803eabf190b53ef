"""The port's batched propagation (``propagation_mode="batched"``,
``xivo_tpu_torch/filter/propagate_batched.py``) against the JAX package,
on the CPU in float64.

* one frame of ``propagate_frame_batched`` from a state with a dense
  covariance and nonzero slopes, on IMU rows with padding (dt = 0) in the
  middle and at the end, an interval longer than max_substeps x h0 (its
  substeps are clipped at the cap, so each is longer than h0), and a
  frame with no IMU sample at all (the frame segment alone, with the
  stored slopes): every leaf within 1e-10;
* the prefix scan and the pairwise reduction against a plain loop;
* 20 frames of ``config_from_json(PCW_CFG, propagation_mode="batched")``
  (the full form, as the mode requires) at the tiny Dims, two sequences:
  poses and every leaf of the final state within 1e-8, counts exact;
* ``runner.fit_substeps`` returns a batched config unchanged: its grid is
  ``total_substeps`` slots of at most ``max_substeps`` a interval, and
  no capped loop runs (``propagate.uses_substep_loop`` is false).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_pipeline import TINY, _walk, plain
from xivo_tpu.filter.config import config_from_json as jax_config_from_json
from xivo_tpu.filter.layout import Dims as JaxDims
from xivo_tpu.filter.propagate_batched import \
    propagate_frame_batched as jax_propagate_batched
from xivo_tpu.runner import batch_states as jax_batch_states
from xivo_tpu.runner import make_batch_runner as jax_batch_runner
from xivo_tpu.sim.configs import PCW_CFG as JAX_PCW_CFG
from xivo_tpu.sim.stream import build_pcw_stream as jax_stream
from xivo_tpu_torch import interop
from xivo_tpu_torch.filter import propagate, propagate_batched as tpb
from xivo_tpu_torch.filter.config import config_from_json
from xivo_tpu_torch.filter.layout import Dims
from xivo_tpu_torch.runner import fit_substeps, make_batch_runner
from xivo_tpu_torch.sim.configs import PCW_CFG
from xivo_tpu_torch.sim.stream import build_pcw_stream

torch.set_num_threads(2)
FRAMES = 20
SEEDS = (1, 2)
BATCHED = dict(dtype="float64", sim_initialize_depths=True,
               propagation_mode="batched")


def cfgs():
    jc = jax_config_from_json(JAX_PCW_CFG, dims=JaxDims(*TINY), **BATCHED)
    tc = config_from_json(PCW_CFG, dims=Dims(*TINY), **BATCHED)
    assert plain(jc) == plain(tc) and tc.covariance_form == "full"
    return jc, tc


def frame_inputs(rng, cfg):
    """Three sequences' IMU rows (B, KI): sequence 0 regular 100 Hz
    samples with padding in the middle and at the end, sequence 1 an
    interval of 3 x max_substeps x h0 (clipped at the cap) among regular
    ones, sequence 2 no sample at all."""
    h0, S = cfg.stepsize, cfg.max_substeps
    dt = np.array([[0.01, 0.0, 0.01, 0.01, 0.0, 0.0],
                   [0.01, 3 * S * h0, 0.004, 0.0, 0.0, 0.0],
                   [0.0] * 6])
    gyro = rng.standard_normal(dt.shape + (3,)) * 0.5
    accel = rng.standard_normal(dt.shape + (3,)) + np.array([0, 0, 9.8])
    gyro[dt == 0] = 0.0
    accel[dt == 0] = 0.0
    return gyro, accel, dt, np.array([0.007, 0.003, 0.02])


def test_one_frame_matches_reference():
    jc, tc = cfgs()
    rng = np.random.default_rng(3)
    gyro, accel, dt, dt_eff = frame_inputs(rng, tc)
    B = dt.shape[0]
    js = jax_batch_states(jc, B)
    D = tc.dims.full
    A = rng.standard_normal((B, D, D)) * 0.05
    js = js._replace(
        P=jnp.asarray(A @ np.swapaxes(A, 1, 2) + np.eye(D)),
        last_gyro=jnp.asarray(rng.standard_normal((B, 3)) * 0.3),
        last_accel=jnp.asarray(rng.standard_normal((B, 3)) + [0, 0, 9.8]),
        slope_gyro=jnp.asarray(rng.standard_normal((B, 3))),
        slope_accel=jnp.asarray(rng.standard_normal((B, 3))),
        X=js.X._replace(Vsb=jnp.asarray(rng.standard_normal((B, 3))),
                        bg=jnp.asarray(rng.standard_normal((B, 3)) * 0.01)))
    jn = jax.tree.map(np.asarray, js)
    ref = jax.jit(jax.vmap(lambda s, g, a, d, f: jax_propagate_batched(
        jc, s, g, a, d, f)))(js, *map(jnp.asarray, (gyro, accel, dt, dt_eff)))
    got = tpb.propagate_frame_batched(
        tc, interop.state_from_numpy(jn, "cpu"),
        *map(torch.from_numpy, (gyro, accel, dt, dt_eff)))
    for path, d in _walk(interop.state_to_numpy(got),
                         jax.tree.map(np.asarray, ref)):
        assert d <= 1e-10, (path, d)
    # the frame moved every sequence, the one without IMU samples too
    moved = np.abs(np.asarray(ref.X.Tsb) - jn.X.Tsb).max(-1)
    assert (moved > 1e-4).all(), moved


def test_scan_and_reduction_match_a_loop():
    rng = np.random.default_rng(4)
    dR = torch.from_numpy(rng.standard_normal((2, 13, 3, 3)))
    want = [dR[:, 0]]
    for k in range(1, 13):
        want.append(want[-1] @ dR[:, k])
    torch.testing.assert_close(tpb._prefix_products(dR),
                               torch.stack(want, 1), rtol=1e-12, atol=1e-12)
    Phi = torch.from_numpy(rng.standard_normal((2, 11, 5, 5)) * 0.3)
    Q = torch.from_numpy(rng.standard_normal((2, 11, 5, 5)))
    P_acc, Q_acc = Phi[:, 0], Q[:, 0]
    for k in range(1, 11):
        P_acc = Phi[:, k] @ P_acc
        Q_acc = Phi[:, k] @ Q_acc @ Phi[:, k].transpose(-1, -2) + Q[:, k]
    P_tot, Q_tot = tpb._compose_transitions(Phi, Q)
    torch.testing.assert_close(P_tot, P_acc, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(Q_tot, Q_acc, rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def walk():
    jc, tc = cfgs()
    kw = dict(total_time=FRAMES * 0.05, noise_px=0.25)
    jstreams = [jax_stream(jc, seed=sd, **kw) for sd in SEEDS]
    tstreams = [build_pcw_stream(tc, seed=sd, **kw) for sd in SEEDS]
    js = jax_batch_states(jc, len(SEEDS))
    js = js._replace(
        last_gyro=jnp.asarray(np.stack([g["gyro0"] for _, g in jstreams])),
        last_accel=jnp.asarray(np.stack([g["accel0"] for _, g in jstreams])))
    ts = interop.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    jfi = jax.tree.map(lambda *x: jnp.stack(x), *[f for f, _ in jstreams])
    tfi = type(tstreams[0][0])(*(np.stack(x) for x in
                                 zip(*[f for f, _ in tstreams])))
    tout = make_batch_runner(tc)(ts, tfi)
    jout = jax_batch_runner(jc)(js, jfi)
    return jax.tree.map(np.asarray, jout), tout, tstreams


def test_walk_matches_reference_over_20_frames(walk):
    (js, jo), (ts, to), streams = walk
    for name in jo._fields:
        a, b = np.asarray(getattr(jo, name)), getattr(to, name).numpy()
        assert a.shape == b.shape == (len(SEEDS), FRAMES) + a.shape[2:]
        if np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-8,
                                       err_msg=name)
    for path, d in _walk(interop.state_to_numpy(ts), js):
        assert d <= 1e-8, (path, d)
    assert int(jo.num_instate_features[:, -1].min()) > 0
    err = np.linalg.norm(to.Tsb[0].numpy() - streams[0][1]["Tsb"], axis=1)
    assert np.isfinite(err).all() and err.max() < 0.05, err


def test_fit_substeps_leaves_a_batched_config_alone(walk):
    _, tc = cfgs()
    fi = walk[2][0][0]
    for cfg in (tc, dataclasses.replace(tc, fast_substeps=0),
                dataclasses.replace(tc, max_substeps=3)):
        assert not propagate.uses_substep_loop(cfg)
        assert fit_substeps(cfg, fi) is cfg
    # the capped loops' configs are still sized to the stream
    for cfg in (dataclasses.replace(tc, propagation_mode="fast",
                                    fast_substeps=0, max_substeps=99),
                dataclasses.replace(tc, propagation_mode="reference",
                                    integration_method="RK4",
                                    max_substeps=99)):
        assert propagate.uses_substep_loop(cfg)
        assert fit_substeps(cfg, fi).max_substeps < 99
