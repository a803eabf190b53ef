"""The port's distribution layer (``xivo_tpu_torch/dist/``,
``runner.make_sharded_runner``) at N = 2 on the CPU, against the JAX
package's distributed functions and against the port's own
single-process path, in float64.

Two ranks of a gloo group on 127.0.0.1 run as child processes of this
module (``spawn_ranks``); each imports the port alone (it checks that no
JAX module was loaded), reads the inputs the test process saved, runs
every distributed job and saves its results. The reference runs here
meanwhile, on a two-device mesh of the emulated CPU devices
(``tests/conftest.py``). Each rank gets a wall limit and the collectives
a timeout, and a rank that fails fails the tests.

* ``make_sharded_matcher`` on ``tests/test_dist.py``'s planted case and
  on ties across the two shards, invalid entries and a sequence with no
  valid entry: indices and distances equal to the reference's sharded
  matcher, to its single search and to the port's ``hamming_nn``;
* ``detect_loop_closures(matcher=)`` on the drift scenario's mapped
  state (``test_torch_mapper.py``): equal to the call without it;
* ``make_distributed_solver`` on ``test_ba.make_problem(K=8, Lm=64)``:
  poses, landmarks and the chi2 history within 1e-8 of the reference's
  distributed solver and of the port's ``ba.solve``, the same on both
  ranks; ``refine_map(mesh=)`` on ``test_bigmap``'s map within 1e-8 of
  ``refine_map()``;
* ``make_sharded_runner`` on ``test_multihost._global_inputs`` (B = 8,
  3 frames, tiny Dims): outputs and final states within 1e-10 of the
  reference's sharded runner and of the port's ``run_batch`` of the
  global batch, counts exactly, also with ``do_outlier_rejection`` on
  (each rank cuts its homography draws from the global batch's); a
  batch that does not split raises ValueError;
* ``make_multihost_runner``: the ranks' host-local rows joined equal the
  global run; ``init_distributed`` without a cluster returns False and
  NCCL without CUDA raises; ``global_mesh`` refuses a backend other than
  that of the group already up.

``spawn_ranks`` and ``port_cfg`` are shared with
``test_torch_segments.py``.
"""
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RANKS = 2
RANK_WALL_S = 240        # a rank still running after this fails the test
COLLECTIVE_TIMEOUT_S = 60
TOL_BA, TOL_RUN = 1e-8, 1e-10
WALK_B, WALK_FRAMES = 4, 16
COUNTS = ("num_instate_features", "num_instate_groups", "num_tracked",
          "num_mh_rejected", "num_oneptransac_rejected",
          "num_tracker_outlier_rejected", "num_oos_dropped")


def port_cfg(**over):
    """The tiny float64 square-root config of ``test_torch_pipeline``."""
    from xivo_tpu_torch.filter.config import config_from_json
    from xivo_tpu_torch.filter.layout import Dims
    from xivo_tpu_torch.sim.configs import PCW_CFG
    kw = dict(dims=Dims(4, 8, 16, 32), dtype="float64",
              sim_initialize_depths=True, propagation_mode="fast",
              covariance_form="sqrt")
    kw.update(over)
    return config_from_json(PCW_CFG, **kw)


# --------------------------------------------------------------------------
# the ranks


def spawn_ranks(script, workdir, n=N_RANKS):
    """Start n ranks of ``python script rank <r> <n> <port> <workdir>``."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    procs = []
    for r in range(n):
        log = open(os.path.join(workdir, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(script), "rank", str(r), str(n),
             str(port), str(workdir)], env=env, cwd=ROOT, stdout=log,
            stderr=subprocess.STDOUT), log))
    return procs


def wait_ranks(procs, workdir, wall_s=RANK_WALL_S):
    """Wait for every rank; if one fails or the wall limit passes, stop
    them all and fail with their logs. Returns each rank's results."""
    deadline = time.time() + wall_s
    while True:
        codes = [p.poll() for p, _ in procs]
        if all(c == 0 for c in codes):
            break
        if any(c not in (None, 0) for c in codes) or time.time() > deadline:
            for p, _ in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            logs = []
            for r, (p, log) in enumerate(procs):
                log.close()
                with open(os.path.join(workdir, f"rank{r}.log")) as f:
                    logs.append(f"rank {r} exit {p.returncode}:\n"
                                f"{f.read()[-3000:]}")
            pytest.fail("a rank failed or ran out of time\n" + "\n".join(logs))
        time.sleep(0.2)
    for _, log in procs:
        log.close()
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(len(procs))]


def rank_main(jobs):
    """A rank's process: join the gloo group, run jobs(group, inputs) ->
    results, save them with the JAX check, leave the group."""
    import torch.distributed as dist

    from xivo_tpu_torch.dist import multihost
    rank, n, port, workdir = (int(sys.argv[2]), int(sys.argv[3]),
                              sys.argv[4], sys.argv[5])
    multihost.TIMEOUT_S = COLLECTIVE_TIMEOUT_S
    assert multihost.init_distributed(f"127.0.0.1:{port}", n, rank,
                                      backend="gloo")
    group = multihost.global_mesh("gloo")
    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    out = jobs(group, inputs)
    out["jax_loaded"] = sorted(m for m in sys.modules
                               if m.split(".")[0] in ("jax", "jaxlib",
                                                      "xivo_tpu"))
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def rank_jobs(group, inp):
    from xivo_tpu_torch.dist import (make_distributed_solver,
                                     make_sharded_matcher, shard_problem)
    from xivo_tpu_torch.dist.multihost import (all_gather_dim,
                                               global_to_host_local,
                                               make_multihost_runner,
                                               rank_rows)
    from xivo_tpu_torch.filter.state import tree_map
    from xivo_tpu_torch.map import mapper as tm
    from xivo_tpu_torch.map.bigmap import refine_map
    from xivo_tpu_torch.runner import make_sharded_runner
    out = {}
    match = make_sharded_matcher(group)
    out["match"] = match(*inp["match"])
    tc, ts, tms, u = inp["drift"]
    out["detect"] = tm.detect_loop_closures(tc, ts, tms, u, matcher=match)

    p, kw = inp["ba"]
    solver = make_distributed_solver(group, **kw)
    p_sh, hist = solver(shard_problem(p, group))
    out["ba_local_lm"] = p_sh.Xs.shape[1]
    out["ba"] = (p_sh._replace(Xs=all_gather_dim(p_sh.Xs, 1, group)), hist)
    bm, kw = inp["bigmap"]
    out["refine"] = refine_map(None, bm, mesh=group, **kw)

    states, fib = inp["runner"]
    out["sharded_reference"] = make_sharded_runner(port_cfg(), group)(
        states, fib)
    states, fib = inp["walk"]
    for name, cfg in (("plain", port_cfg()),
                      ("rejection", port_cfg(do_outlier_rejection=True))):
        out[f"sharded_{name}"] = make_sharded_runner(cfg, group)(states, fib)
    lo, hi = rank_rows(states.P.shape[0], group)
    out["multihost"] = make_multihost_runner(
        port_cfg(do_outlier_rejection=True), group)(
            global_to_host_local(states, group),
            type(fib)(*(a[lo:hi] for a in fib)))
    try:
        make_sharded_runner(port_cfg(), group)(
            tree_map(lambda x: x[:3], states),
            type(fib)(*(a[:3] for a in fib)))
        out["uneven"] = None
    except ValueError as e:
        out["uneven"] = str(e)
    return out


# --------------------------------------------------------------------------
# the inputs and the reference


def lead(tree):
    import jax
    return jax.tree.map(lambda x: np.asarray(x)[None], tree)


def match_inputs():
    """test_dist.py's planted case as sequence 0; sequence 1: copies of the
    queries at rows 700.. (the second shard) and, one bit off, 300.. (the
    first; the planted copies at 100.. overwritten), a
    closer copy of query 8 only at row 900, its near copies invalid at
    row 10; sequence 2: no valid entry."""
    rng = np.random.default_rng(0)
    M, F = 1024, 16
    mdesc = rng.integers(0, 2 ** 32, (M, 8), dtype=np.uint32)
    qdesc = rng.integers(0, 2 ** 32, (F, 8), dtype=np.uint32)
    qdesc[:8] = mdesc[100:108]
    q = np.stack([qdesc] * 3).astype(np.int64)
    d = np.stack([mdesc] * 3).astype(np.int64)
    v = np.ones((3, M), bool)
    d[1, 100:108] = d[1, 200:208]          # the planted copies moved
    d[1, 700:708] = q[1, :8]
    d[1, 300:308] = q[1, :8]
    d[1, 300:308, 0] ^= 1                # one bit off: 700.. wins for 0-7
    d[1, 900] = q[1, 8]
    d[1, 10] = q[1, 8]
    v[1, 10] = False
    v[2] = False
    return (torch.from_numpy(q), torch.from_numpy(d), torch.from_numpy(v)), \
        (qdesc, mdesc)


def make_inputs():
    import jax
    import jax.numpy as jnp

    from test_torch_mapped_pipeline import reference_draws
    from test_torch_mapper import port_map
    from tests.test_ba import make_problem
    from tests.test_bigmap import PCW_CFG as BIG_CFG
    from tests.test_bigmap import synthetic_bigmap
    from tests.test_mapper import _drift_scenario
    from tests.test_multihost import _global_inputs
    from xivo_tpu.filter import layout as JL
    from xivo_tpu.filter.config import config_from_json as jax_cfg
    from xivo_tpu.filter.state import init_state as jax_init_state
    from xivo_tpu.sim.configs import PCW_CFG as JAX_PCW_CFG
    from xivo_tpu_torch import interop
    from xivo_tpu_torch.ba.core import BAProblem
    from xivo_tpu_torch.filter.config import config_from_json
    from xivo_tpu_torch.sim.configs import PCW_CFG
    ref = {}
    inp = {}
    inp["match"], ref["match_raw"] = match_inputs()

    # the drift scenario (test_torch_mapper.drift)
    _, s_full, ms, _ = _drift_scenario()
    form = dict(dtype="float64", propagation_mode="fast",
                covariance_form="sqrt")
    jc = jax_cfg(JAX_PCW_CFG, **form)
    s = jax_init_state(jc)
    P = s.P.at[JL.TSB:JL.TSB + 3, JL.TSB:JL.TSB + 3].set(
        0.5 * jnp.eye(3, dtype=jnp.float64))
    s = s._replace(X=s_full.X, features=s_full.features,
                   f2row=s_full.f2row, P=P)
    tc = config_from_json(PCW_CFG, **form)
    _, u = reference_draws(s.key[None], tc.dims.n_features, jnp.float64)
    inp["drift"] = (tc, interop.state_from_numpy(lead(s), "cpu"),
                    port_map(ms), torch.from_numpy(np.array(u)))

    jp, _ = make_problem(K=8, Lm=64, perturb=0.05)
    kw = dict(iters=8, damping=1e-5)
    inp["ba"] = (BAProblem(*(torch.from_numpy(np.array(x))
                             for x in lead(jp))), kw)
    ref["ba_jax"] = jp

    bcfg = jax_cfg(BIG_CFG, dtype="float64", sim_initialize_depths=True)
    bm, _, _ = synthetic_bigmap(bcfg)
    inp["bigmap"] = (interop.bigmap_from_numpy(lead(bm), "cpu"),
                     dict(iters=12, damping=1e-6))

    from xivo_tpu.filter.layout import Dims as JaxDims
    jrc = jax_cfg(JAX_PCW_CFG, dims=JaxDims(4, 8, 16, 32), dtype="float64",
                  sim_initialize_depths=True, propagation_mode="fast",
                  covariance_form="sqrt")
    js, jfib = _global_inputs(jrc)
    from xivo_tpu_torch.runner import FrameInputs
    inp["runner"] = (interop.state_from_numpy(jax.tree.map(np.asarray, js),
                                              "cpu"),
                     FrameInputs(*(np.asarray(a) for a in jfib)))
    ref["runner_jax"] = (jrc, js, jfib)
    inp["walk"] = walk_inputs()
    return inp, ref


def walk_inputs(B=WALK_B, frames=WALK_FRAMES):
    """B PCW sequences (seeds 1..B) of `frames` frames, outliers planted
    from frame 5 on, with their seeded states: features enter the state
    and the homography rejection has work."""
    from xivo_tpu_torch.runner import FrameInputs, batch_states
    from xivo_tpu_torch.sim.stream import (build_pcw_stream,
                                           corrupt_measurements)
    cfg = port_cfg()
    streams = [build_pcw_stream(cfg, total_time=frames * 0.05,
                                noise_px=0.25, seed=sd)
               for sd in range(1, B + 1)]
    fis = [corrupt_measurements(fi, 100 + k, start=5)
           for k, (fi, _) in enumerate(streams)]
    fib = FrameInputs(*(np.stack(a) for a in zip(*fis)))
    s = batch_states(cfg, B, "cpu")
    return s._replace(
        last_gyro=torch.tensor(np.stack([g["gyro0"] for _, g in streams])),
        last_accel=torch.tensor(np.stack([g["accel0"]
                                          for _, g in streams]))), fib


def reference_results(inp, ref):
    """The JAX package's distributed functions on a 2-device mesh, and the
    port's single-process path."""
    import jax
    from jax.sharding import Mesh

    from xivo_tpu.dist import (make_distributed_solver as jax_solver,
                               make_sharded_matcher as jax_matcher,
                               shard_problem as jax_shard)
    from xivo_tpu.frontend import brief
    from xivo_tpu.runner import make_sharded_runner as jax_sharded
    from xivo_tpu_torch.ba.core import solve
    from xivo_tpu_torch.map import mapper as tm
    from xivo_tpu_torch.map.bigmap import refine_map
    from xivo_tpu_torch.runner import inputs_to_device, run_batch
    mesh = Mesh(np.asarray(jax.devices()[:N_RANKS]), ("data",))
    out = {}
    qdesc, mdesc = ref["match_raw"]
    q, d, v = inp["match"]
    out["match_jax"] = jax.tree.map(np.asarray, jax_matcher(mesh)(
        qdesc, mdesc, np.ones(mdesc.shape[0], bool)))
    singles = []
    for b in range(q.shape[0]):
        D = np.asarray(brief.hamming_matrix(q[b].numpy().astype(np.uint32),
                                            d[b].numpy().astype(np.uint32)))
        D = np.where(v[b].numpy()[None], D, 10_000)
        singles.append((D.argmin(1), D.min(1)))
    out["match_single"] = singles

    tc, ts, tms, u = inp["drift"]
    out["detect"] = tm.detect_loop_closures(tc, ts, tms, u)

    p, kw = inp["ba"]
    jp = ref["ba_jax"]
    out["ba_jax"] = jax.tree.map(np.asarray, jax_solver(mesh, **kw)(
        jax_shard(jp, mesh)))
    out["ba_port"] = solve(p, **kw)
    bm, kw = inp["bigmap"]
    out["refine"] = refine_map(None, bm, **kw)

    jrc, js, jfib = ref["runner_jax"]
    out["sharded_jax"] = jax.tree.map(np.asarray,
                                      jax_sharded(jrc, mesh)(js, jfib))
    states, fib = inp["walk"]
    dev = inputs_to_device(fib, "cpu")
    for name, cfg in (("plain", port_cfg()),
                      ("rejection", port_cfg(do_outlier_rejection=True))):
        out[f"batch_{name}"] = run_batch(cfg, states, dev)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(inputs, the rank results, the reference's results)."""
    workdir = tmp_path_factory.mktemp("ranks")
    inp, ref = make_inputs()
    torch.save(inp, workdir / "inputs.pt")
    procs = spawn_ranks(__file__, str(workdir))
    try:
        refs = reference_results(inp, ref)
    finally:
        outs = wait_ranks(procs, str(workdir))
    for o in outs:
        assert o["jax_loaded"] == [], o["jax_loaded"]
    return inp, outs, refs


# --------------------------------------------------------------------------
# the tests


def same(a, b, name=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, name
    np.testing.assert_array_equal(a, b, err_msg=name)


def test_sharded_matcher_matches_reference(ranks):
    _, outs, refs = ranks
    nn_j, d_j = refs["match_jax"]
    for o in outs:
        nn, dd = (x.numpy() for x in o["match"])
        same(nn[0], nn_j, "idx")
        same(dd[0], d_j, "dist")
        assert (dd[0, :8] == 0).all() and (nn[0, :8] == np.arange(100, 108)
                                           ).all()


def test_sharded_matcher_ties_and_empty_maps(ranks):
    inp, outs, refs = ranks
    from xivo_tpu_torch.ops.hamming import hamming_nn
    d_p, i_p = hamming_nn(*inp["match"])
    for o in outs:
        nn, dd = o["match"]
        same(nn, i_p, "idx")
        same(dd, d_p, "dist")
        for b in range(2):
            same(nn[b], refs["match_single"][b][0], f"idx {b}")
            same(dd[b], refs["match_single"][b][1], f"dist {b}")
    nn, dd = outs[0]["match"]
    assert (nn[1, :8] == torch.arange(700, 708)).all()     # second shard
    assert nn[1, 8] == 900 and dd[1, 8] == 0               # valid copy
    assert (nn[2] == 0).all() and (dd[2] == 10_000).all()  # no entry


def test_detect_loop_closures_with_matcher(ranks):
    _, outs, refs = ranks
    want = refs["detect"]
    assert bool(want[3][0]) and int(want[2].sum()) >= 5
    for o in outs:
        for name, a, b in zip(("rows", "idx", "inliers", "any"), o["detect"],
                              want):
            same(a, b, name)


def test_distributed_solver_matches_reference(ranks):
    inp, outs, refs = ranks
    jp, jh = refs["ba_jax"]
    tp, th = refs["ba_port"]
    for o in outs:
        p, h = o["ba"]
        assert o["ba_local_lm"] == inp["ba"][0].Xs.shape[1] // N_RANKS
        for want, wh in ((lead(jp), np.asarray(jh)[None]), (tp, th)):
            for f in ("Rs", "Ts", "Xs"):
                np.testing.assert_allclose(
                    getattr(p, f).numpy(), np.asarray(getattr(want, f)),
                    rtol=TOL_BA, atol=TOL_BA, err_msg=f)
            np.testing.assert_allclose(h.numpy(), np.asarray(wh),
                                       rtol=TOL_BA, atol=TOL_BA)
    h = outs[0]["ba"][1][0].numpy()
    assert h[-1] < 1e-3 * h[0]
    same(outs[0]["ba"][0].Ts, outs[1]["ba"][0].Ts, "replicated poses")


def test_refine_map_mesh_matches_single_process(ranks):
    from xivo_tpu_torch import interop
    _, outs, refs = ranks
    bm1, chi1 = refs["refine"]
    want = interop.bigmap_to_numpy(bm1)
    for o in outs:
        bm, chi = o["refine"]
        np.testing.assert_allclose(chi.numpy(), chi1.numpy(), rtol=TOL_BA,
                                   atol=TOL_BA)
        got = interop.bigmap_to_numpy(bm)
        for f in got._fields:
            np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                       rtol=TOL_BA, atol=TOL_BA, err_msg=f)
    assert chi1[0, -1] < 0.05 * chi1[0, 0]


def check_outputs(got, want, tol=TOL_RUN):
    for f in want._fields:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        if f in COUNTS:
            same(a, b, f)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=f)


def check_states(got, want, tol=TOL_RUN):
    """A port state against a port state or the reference's (numpy
    leaves; its PRNG key has no counterpart and is not walked)."""
    from test_torch_pipeline import _walk
    from xivo_tpu_torch import interop
    if isinstance(want.P, torch.Tensor):
        want = interop.state_to_numpy(want)
    for path, d in _walk(interop.state_to_numpy(got), want):
        assert d <= tol, (path, d)


def test_sharded_runner_matches_reference(ranks):
    _, outs, refs = ranks
    js, jo = refs["sharded_jax"]
    for o in outs:
        s, out = o["sharded_reference"]
        check_outputs(out, jo)
        check_states(s, js)


@pytest.mark.parametrize("name", ["plain", "rejection"])
def test_sharded_runner_matches_run_batch(ranks, name):
    _, outs, refs = ranks
    s1, o1 = refs[f"batch_{name}"]
    assert (o1.num_instate_features[:, -1] > 0).all()
    if name == "rejection":
        assert int(o1.num_tracker_outlier_rejected.sum()) > 0
    for o in outs:
        s, out = o[f"sharded_{name}"]
        check_outputs(out, o1)
        check_states(s, s1)


def test_multihost_runner_rows_join_to_global(ranks):
    _, outs, refs = ranks
    s1, o1 = refs["batch_rejection"]
    assert outs[0]["multihost"][1].Tsb.shape[0] == WALK_B // N_RANKS
    check_outputs(_join([o["multihost"][1] for o in outs]), o1)
    check_states(_join([o["multihost"][0] for o in outs]), s1)


def test_rank_rows_draw_the_global_batchs_rows():
    """``run_batch(rows=)``'s homography draws are the whole batch's, cut;
    a mapped step's draws take no rows."""
    from xivo_tpu_torch.runner import batch_states, draw_generator, frame_draws
    cfg = port_cfg(do_outlier_rejection=True, use_mapper=True)
    s = batch_states(cfg, 6, "cpu")
    g_all, g_part = draw_generator(s), draw_generator(s)
    part = tree_map_rows(s, 2, 4)
    for t in range(3):
        want, _ = frame_draws(cfg, s, g_all, False, t)
        got, none = frame_draws(cfg, part, g_part, False, t, rows=(2, 6))
        assert none is None
        same(got, want[2:4])
    with pytest.raises(ValueError, match="homography"):
        frame_draws(cfg, part, g_part, True, rows=(2, 6))


def tree_map_rows(s, lo, hi):
    from xivo_tpu_torch.filter.state import tree_map
    return tree_map(lambda x: x[lo:hi], s)


def _join(trees):
    if isinstance(trees[0], tuple):
        return type(trees[0])(*(_join(list(x)) for x in zip(*trees)))
    return torch.cat(trees, 0)


def test_sharded_runner_refuses_uneven_batch(ranks):
    _, outs, _ = ranks
    for o in outs:
        assert o["uneven"] is not None and "3 rows" in o["uneven"]


def test_init_distributed_without_a_cluster(monkeypatch):
    from xivo_tpu_torch.dist.multihost import init_distributed
    for k in ("XIVO_COORDINATOR", "XIVO_NUM_PROCESSES", "XIVO_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() is False
    assert init_distributed("127.0.0.1:1", 1, 0) is False
    monkeypatch.setenv("XIVO_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("XIVO_NUM_PROCESSES", "2")
    monkeypatch.setenv("XIVO_PROCESS_ID", "0")
    if not torch.cuda.is_available():
        # the default backend is NCCL, and nothing falls back to gloo
        with pytest.raises(RuntimeError, match="NCCL"):
            init_distributed()


def test_global_mesh_refuses_another_backend():
    """Once a group is up, asking for another backend raises rather than
    handing back the group that is up."""
    import torch.distributed as dist

    from xivo_tpu_torch.dist.multihost import global_mesh
    try:
        group = global_mesh("gloo")
        assert global_mesh() is group and global_mesh("gloo") is group
        with pytest.raises(RuntimeError, match="gloo group is up"):
            global_mesh("nccl")
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


if __name__ == "__main__" and len(sys.argv) > 1 and sys.argv[1] == "rank":
    sys.path.insert(0, ROOT)
    torch.set_num_threads(1)
    rank_main(rank_jobs)
