"""The reference integrators of the port against the JAX package, float64
on the CPU.

* ``_rk4_substep`` and ``_pd_substep`` on a batch of random motion states
  and motion covariances, within 1e-12 relative to each output's largest
  entry;
* ``propagate_interval`` (RK4, fixed-step Prince-Dormand and adaptive
  Prince-Dormand at ``pd_tolerance`` 1e-4) and ``propagate_interval_fast``
  (the ``fast_substeps=0`` loop, ROADMAP C.1) on one batch whose
  sequences have intervals of 0, 0.3, 1.2, 2.5 and 5 h0: the empty
  interval, a single short step, the half-step trick and the masked tail
  of a batch where each sequence stops after its own number of substeps.
  Within 1e-10 relative; the reference runs each sequence's while loop
  under ``vmap``;
* ``imu_sample_update`` with ``clamp_signals`` on a dense P, a padded
  (dt = 0) sample included;
* the capped loops count what they leave unfinished, and the runner
  raises on it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xivo_tpu.filter import propagate as jp
from xivo_tpu.filter.state import init_state as jax_init_state
from xivo_tpu_torch import interop
from xivo_tpu_torch.filter import propagate as tp
from xivo_tpu_torch.runner import _fixed_substeps

from test_torch_pipeline import jax_cfg, torch_cfg
from test_torch_propagate_features import motion, t

torch.set_num_threads(2)
RNG = np.random.default_rng(11)
SUBSTEP_TOL = 1e-12
INTERVAL_TOL = 1e-10
M = 39
CROSS = 20                  # columns of the motion/structure block here
FULL = dict(propagation_mode="reference", covariance_form="full")


def cfgs(**over):
    """(reference config, port config) of the tiny PCW config with the
    reference's default filter and `over` on top."""
    kw = dict(FULL, **over)
    return (dataclasses.replace(jax_cfg(), **kw),
            dataclasses.replace(torch_cfg(), **kw))


def spd(n, m):
    A = RNG.standard_normal((n, m, m)) * 0.1
    return A @ A.transpose(0, 2, 1) + 1e-3 * np.eye(m)


def rel_close(a, b, tol, name=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, name
    scale = max(float(np.abs(b).max()), 1e-300)
    err = float(np.abs(a - b).max()) / scale
    assert err <= tol, (name, err)


def inputs(n):
    jx, tx = motion(n)
    gy = RNG.standard_normal((n, 3)) * 0.3
    ac = np.array([0.0, 0.0, 9.8]) + RNG.standard_normal((n, 3))
    sg, sa = RNG.standard_normal((n, 3)), RNG.standard_normal((n, 3))
    return jx, tx, gy, ac, sg, sa


def stack(jx):
    return jax.tree.map(lambda *v: jnp.stack(v), *jx)


@pytest.mark.parametrize("method", ["RK4", "PrinceDormand"])
def test_substep_matches_reference(method):
    jc, tc = cfgs()
    n = 4
    jx, tx, gy, ac, sg, sa = inputs(n)
    Pmm = spd(n, M)
    h = np.array([0.002, 0.0013, 0.0007, 0.004])
    g = np.asarray(jc.gravity, np.float64)
    Q = tp.imu_noise(tc, torch.float64, "cpu")
    ref = {"RK4": jp._rk4_substep, "PrinceDormand": jp._pd_substep}[method]
    port = {"RK4": tp._rk4_substep, "PrinceDormand": tp._pd_substep}[method]
    out_j = jax.vmap(lambda X, P, a, b, c, d, hh: ref(
        X, P, a, b, c, d, hh, jnp.asarray(g), jnp.asarray(Q.numpy()),
        jnp.float64))(stack(jx), jnp.asarray(Pmm), *(jnp.asarray(v) for v in
                                                       (gy, ac, sg, sa, h)))
    out_t = port(tx, t(Pmm), t(gy), t(ac), t(sg), t(sa), t(h),
                 t(g), Q)
    Xj, Pj, Fj, ej = out_j
    Xt, Pt, Ft, et = out_t
    for k in Xj._fields:
        rel_close(getattr(Xt, k).numpy(), getattr(Xj, k), SUBSTEP_TOL, k)
    rel_close(Pt.numpy(), Pj, SUBSTEP_TOL, "Pmm")
    rel_close(Ft.numpy(), Fj, SUBSTEP_TOL, "Ftot")
    if method == "PrinceDormand":
        assert float(np.abs(np.asarray(ej)).min()) > 0
        rel_close(et.numpy(), ej, SUBSTEP_TOL, "err")
    else:
        assert not et.any() and not np.asarray(ej).any()


H0 = 0.002
DTS = np.array([0.0, 0.3, 1.2, 2.5, 5.0]) * H0
ADAPTIVE_MOST = 3           # the most substeps adaptive PD takes here
LOOPS = {"rk4": dict(integration_method="RK4"),
         "pd": {},
         "pd_adaptive": dict(pd_control_stepsize=True, pd_tolerance=1e-4),
         "fast_loop": dict(propagation_mode="fast", fast_substeps=0)}


@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_interval_matches_reference(loop):
    jc, tc = cfgs(max_substeps=40, **LOOPS[loop])
    assert jc.stepsize == H0
    n = len(DTS)
    jx, tx, gy, ac, sg, sa = inputs(n)
    Pmm, Pms = spd(n, M), RNG.standard_normal((n, M, CROSS)) * 0.1
    tp.reset_substep_counts("cpu")
    args = [jnp.asarray(v) for v in (gy, ac, sg, sa, DTS)]
    if loop == "fast_loop":
        Xj, Aj, Bj = jax.jit(jax.vmap(
            lambda X, a, b, c, d, e: jp.propagate_interval_fast(
                jc, X, a, b, c, d, e)))(stack(jx), *args)
        Xt, At, Bt = tp.propagate_interval_fast(
            tc, tx, *(t(v) for v in (gy, ac, sg, sa, DTS)))
    else:
        Xj, Aj, Bj = jax.jit(jax.vmap(
            lambda X, P, S, a, b, c, d, e: jp.propagate_interval(
                jc, X, P, S, a, b, c, d, e)))(
                    stack(jx), jnp.asarray(Pmm), jnp.asarray(Pms), *args)
        Xt, At, Bt = tp.propagate_interval(
            tc, tx, t(Pmm), t(Pms), *(t(v) for v in (gy, ac, sg, sa, DTS)))
    most = tp.check_substeps("cpu")
    for k in Xj._fields:
        for i in range(n):
            rel_close(getattr(Xt, k)[i].numpy(), getattr(Xj, k)[i],
                      INTERVAL_TOL, (k, i))
    for i in range(n):
        rel_close(At[i].numpy(), Aj[i], INTERVAL_TOL, ("Pmm/Phi", i))
        rel_close(Bt[i].numpy(), Bj[i], INTERVAL_TOL, ("Pms/Q", i))
    # the empty interval is a no-op; the others moved
    assert torch.equal(Xt.Tsb[0], tx.Tsb[0])
    assert (Xt.Tsb[1:] != tx.Tsb[1:]).all()
    # the fixed-step loops take what the runner's sizing predicts for the
    # longest interval; adaptive steps grow by up to pd_max_scale after
    # the first, so they take fewer
    fixed = _fixed_substeps(DTS.max(), H0, np.float64)
    if loop == "pd_adaptive":
        assert most == ADAPTIVE_MOST < fixed, most
    else:
        assert most == fixed == 5, most


def test_imu_sample_update_matches_reference():
    """Three sequences: one sample inside the clamp, one beyond it on two
    axes, one padded (dt = 0): the port's batched update against the
    reference's under vmap, on every leaf of the state."""
    over = dict(clamp_signals=True, max_gyro=(1.0, 1.0, 1.0),
                max_accel=(12.0, 12.0, 12.0))
    jc, tc = cfgs(**over)
    n = 3
    jx, _, _, _, _, _ = inputs(n)
    js = jax_init_state(jc)
    D = js.P.shape[0]
    A = RNG.standard_normal((n, D, D)) * 0.05
    P = A @ A.transpose(0, 2, 1)
    js = jax.tree.map(lambda *v: jnp.stack(v), *[
        js._replace(X=jx[i], P=jnp.asarray(P[i]),
                    last_gyro=jnp.asarray(RNG.standard_normal(3) * 0.2),
                    last_accel=jnp.asarray([0.1, 0.2, 9.7]))
        for i in range(n)])
    gyro = np.array([[0.1, -0.2, 0.3], [2.5, -0.2, -3.0], [0.1, 0.1, 0.1]])
    accel = np.array([[0.2, 0.1, 9.9], [0.2, 15.0, 9.9], [0.0, 0.0, 9.8]])
    dt = np.array([0.01, 0.007, 0.0])
    ref = jax.jit(jax.vmap(lambda s, a, b, c: jp.imu_sample_update(
        jc, s, a, b, c)))(js, *(jnp.asarray(v) for v in (gyro, accel, dt)))
    ts = interop.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    out = tp.imu_sample_update(tc, ts, t(gyro), t(accel), t(dt))
    got = interop.state_to_numpy(out)
    ref = jax.tree.map(np.asarray, ref)
    for name in ("Rsb", "Tsb", "Vsb"):
        for i in range(n):
            rel_close(getattr(got.X, name)[i], getattr(ref.X, name)[i],
                      INTERVAL_TOL, name)
    for name in ("P", "last_gyro", "last_accel", "slope_gyro",
                 "slope_accel"):
        for i in range(n):
            rel_close(getattr(got, name)[i], getattr(ref, name)[i],
                      INTERVAL_TOL, (name, i))
    # the padded sample left its sequence exactly as it was
    for a, b in zip(jax.tree.leaves(interop.state_to_numpy(ts)),
                    jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(a)[2], np.asarray(b)[2])
    # the clamp acted: the slopes reach the clamped reading
    lg = np.asarray(js.last_gyro)[1]
    np.testing.assert_allclose(got.slope_gyro[1] * dt[1] + lg,
                               [1.0, -0.2, -1.0], atol=1e-12)


def test_unfinished_intervals_are_counted_and_raise():
    """A cap below what an interval needs leaves it unfinished: the
    counter says so and ``check_substeps`` raises; so does the runner."""
    from xivo_tpu_torch.runner import batch_states, run_batch
    from xivo_tpu_torch.runner import inputs_to_device
    from xivo_tpu_torch.sim.stream import build_pcw_stream
    jc, tc = cfgs(max_substeps=3)
    n = len(DTS)
    _, tx, gy, ac, sg, sa = inputs(n)
    tp.reset_substep_counts("cpu")
    tp.propagate_interval(tc, tx, t(spd(n, M)), t(np.zeros((n, M, 1))),
                          *(t(v) for v in (gy, ac, sg, sa, DTS)))
    unfinished, most = tp.substep_counts("cpu")
    assert (int(unfinished), int(most)) == (1, 3)   # the 5 h0 interval
    with pytest.raises(RuntimeError, match="max_substeps"):
        tp.check_substeps("cpu")
    # through the runner: one frame of the PCW stream (0.01 s IMU
    # intervals, six substeps each in float64)
    fi, gt = build_pcw_stream(tc, total_time=0.1, noise_px=0.25)
    fib = inputs_to_device(type(fi)(*(a[None, :2] for a in fi)), "cpu")
    s = batch_states(tc, 1, device="cpu")
    with pytest.raises(RuntimeError, match="left unfinished"):
        run_batch(tc, s, fib)
    _, out = run_batch(dataclasses.replace(tc, max_substeps=6), s, fib)
    assert int(tp.substep_counts("cpu")[0]) == 0
    assert torch.isfinite(out.Tsb).all()
