"""The port's segment-parallel processing (``xivo_tpu_torch/dist/
segments.py``) against the JAX package, on the CPU in float64.

* ``plan_segments`` and ``split_stream`` exactly equal to the
  reference's; ``yaw_translation_align`` and ``fuse_segments`` within
  1e-12;
* ``seed_segment_states`` (``vi_bootstrap`` a segment at a time; the
  reference vmaps it) within 1e-10, in the square-root and the full form;
* ``run_segment_parallel`` over 4 segments of an orbit at tiny Dims: the
  fused trajectory and the segments' outputs within 1e-8 of the
  reference's (its default, vmapped runner; ``tests/test_dist.py`` and
  ``tests/test_multihost.py`` hold its sharded runner to the same
  program); and at
  N = 2 (two gloo ranks, ``test_torch_dist.spawn_ranks``) with
  ``runner=make_sharded_runner(cfg, group)``, within 1e-10 of the
  port's default runner, counts exactly, the same on both ranks.
"""
import sys

import numpy as np
import pytest
import torch

from test_torch_dist import (COUNTS, ROOT, port_cfg, rank_main, spawn_ranks,
                             wait_ranks)

torch.set_num_threads(2)
SEG = dict(n_segments=4, overlap=10, boot_frames=12)
ORBIT_S = 4.0            # 80 frames: 4 segments of 20 + 10
TOL_SEED, TOL_RUN, TOL_SHARD = 1e-10, 1e-8, 1e-10


def orbit(cfg):
    from xivo_tpu_torch.sim.stream import build_pcw_stream
    fi, gt = build_pcw_stream(cfg, total_time=ORBIT_S, noise_px=0.25,
                              motion="orbit")
    return fi, gt


def rank_jobs(group, inp):
    from xivo_tpu_torch.dist.segments import run_segment_parallel
    from xivo_tpu_torch.runner import make_sharded_runner
    cfg, fi = inp
    return {"sharded": run_segment_parallel(
        cfg, fi, runner=make_sharded_runner(cfg, group), device="cpu",
        **SEG)}


def jax_cfg(**over):
    from xivo_tpu.filter.config import config_from_json
    from xivo_tpu.filter.layout import Dims
    from xivo_tpu.sim.configs import PCW_CFG
    kw = dict(dims=Dims(4, 8, 16, 32), dtype="float64",
              sim_initialize_depths=True, propagation_mode="fast",
              covariance_form="sqrt")
    kw.update(over)
    return config_from_json(PCW_CFG, **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port cfg, stream, rank results, the port's default run, the
    reference's)."""
    import jax

    from xivo_tpu.dist.segments import run_segment_parallel as jax_rsp
    from xivo_tpu.sim.stream import build_pcw_stream as jax_stream
    from xivo_tpu_torch.dist.segments import run_segment_parallel
    cfg = port_cfg()
    fi, _ = orbit(cfg)
    workdir = tmp_path_factory.mktemp("seg_ranks")
    torch.save((cfg, fi), workdir / "inputs.pt")
    procs = spawn_ranks(__file__, str(workdir))
    try:
        jc = jax_cfg()
        jfi, _ = jax_stream(jc, total_time=ORBIT_S, noise_px=0.25,
                            motion="orbit")
        ref = jax_rsp(jc, jfi, **SEG)
        ref = (np.asarray(ref[0]), jax.tree.map(np.asarray, ref[1]))
        mine = run_segment_parallel(cfg, fi, device="cpu", **SEG)
    finally:
        outs = wait_ranks(procs, str(workdir))
    for o in outs:
        assert o["jax_loaded"] == [], o["jax_loaded"]
    return cfg, fi, outs, mine, ref


def test_plan_and_split_match_reference():
    from xivo_tpu.dist import segments as js
    from xivo_tpu_torch.dist import segments as ts
    for T, n, ov in ((80, 4, 10), (81, 4, 10), (100, 3, 0), (7, 7, 2)):
        a, b = js.plan_segments(T, n, ov), ts.plan_segments(T, n, ov)
        np.testing.assert_array_equal(a.starts, b.starts)
        assert (a.seg_len, a.core_len, a.overlap) == \
            (b.seg_len, b.core_len, b.overlap)
    fi, _ = orbit(port_cfg())
    for T, n, ov in ((80, 4, 10), (80, 3, 0)):
        plan = ts.plan_segments(T, n, ov)
        a, b = js.split_stream(fi, plan), ts.split_stream(fi, plan)
        for f, x, y in zip(b._fields, a, b):
            x = np.asarray(x)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


def test_align_and_fuse_match_reference():
    from xivo_tpu.dist import segments as js
    from xivo_tpu_torch.dist import segments as ts
    rng = np.random.default_rng(5)
    p = rng.normal(size=(30, 3))
    th = 0.7
    Rz = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                   [0, 0, 1]])
    q = (Rz @ p.T).T + [1.0, -2.0, 0.5] + rng.normal(0, 1e-3, p.shape)
    for a, b in zip(js.yaw_translation_align(q, p),
                    ts.yaw_translation_align(q, p)):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-12)
    plan = ts.plan_segments(80, 4, 10)
    segs = np.cumsum(rng.normal(0, 0.1, (4, plan.seg_len, 3)), axis=1)
    np.testing.assert_allclose(ts.fuse_segments(segs, plan, 80),
                               js.fuse_segments(segs, plan, 80), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("form", ["sqrt", "full"])
def test_seed_segment_states_matches_reference(form):
    from test_torch_pipeline import _walk
    from xivo_tpu.dist import segments as js
    from xivo_tpu_torch import interop
    from xivo_tpu_torch.dist import segments as ts
    cfg = port_cfg(covariance_form=form)
    fi, _ = orbit(cfg)
    fis = ts.split_stream(fi, ts.plan_segments(80, 4, 10))
    want = js.seed_segment_states(jax_cfg(covariance_form=form), fis, 12)
    got = ts.seed_segment_states(cfg, fis, 12, device="cpu")
    got = interop.state_to_numpy(got)
    for path, d in _walk(got, want):
        assert d <= TOL_SEED, (path, d)
    # the seeds differ segment by segment
    assert np.abs(np.diff(got.X.Vsb, axis=0)).max() > 0.1


def check_outs(got, want, tol):
    for f in got._fields:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        if f in COUNTS:
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=f)


def test_run_segment_parallel_matches_reference(runs):
    _, fi, _, (fused, outs), (jfused, jouts) = runs
    assert fused.shape == (fi.frame_dt.shape[0], 3)
    np.testing.assert_allclose(fused, jfused, rtol=0, atol=TOL_RUN)
    check_outs(outs, jouts, TOL_RUN)
    # every segment holds features by the end of its core
    core = 20
    assert (np.asarray(outs.num_instate_features)[:, core - 1] > 0).all()


def test_run_segment_parallel_sharded_equals_default(runs):
    _, _, ranks, (fused, outs), _ = runs
    for o in ranks:
        f, out = o["sharded"]
        np.testing.assert_allclose(f, fused, rtol=0, atol=TOL_SHARD)
        check_outs(out, outs, TOL_SHARD)
    np.testing.assert_array_equal(ranks[0]["sharded"][0],
                                  ranks[1]["sharded"][0])


if __name__ == "__main__" and len(sys.argv) > 1 and sys.argv[1] == "rank":
    sys.path.insert(0, ROOT)
    torch.set_num_threads(1)
    rank_main(rank_jobs)
