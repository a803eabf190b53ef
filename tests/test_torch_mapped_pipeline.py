"""The port's mapped VIO frame step against the JAX package, on the CPU.

* ``vio_frame_mapped``: 60 frames of two PCW "loop" sequences at the tiny
  Dims of ``__graft_entry__._tiny_cfg`` in float64, with the mapper
  settings of ``scripts/diag_kidnap_pcw.py`` but ``lc_min_age_frames=20``
  (so closures fire within the run), a 256-entry map per sequence and no
  fusion on retirement (``map_merge_on_retire=False``): fusing two
  gauge features' covariances, which are rank 1 (their XY rows are
  frozen), intersects two nearly parallel depth rays, and a difference of
  1e-17 in the inputs moved a fused position by 0.69 m (seen at frame 15
  of this run with fusion on). Fusion is held on the live state after the
  run instead, with the non-gauge rows (``retire_features``), and in
  ``tests/test_torch_mapper.py``.
  The reference draws its P3P RANSAC uniforms from the state's PRNG key
  (``map/mapper.py:237``, ``map/p3p.py:115-118``); the test rebuilds the
  same draws from the key before every frame and hands them to the port.
  Per frame, closure rows and map counts match exactly, and so do the
  map's descriptors, anchor ids, epochs and validity at the end;
  poses within 1e-7 m, map positions within 1e-7 m;
* ``vio_frame_image_mapped``: a few frames of the image path with the
  mapper on, against the reference likewise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pipeline import SLICE, TINY
from xivo_tpu.filter.config import config_from_json as jax_config_from_json
from xivo_tpu.filter.layout import Dims as JaxDims
from xivo_tpu.map import init_map as jax_init_map
from xivo_tpu.map.integration import vio_frame_mapped as jax_vio_frame_mapped
from xivo_tpu.runner import batch_states as jax_batch_states
from xivo_tpu.sim.configs import PCW_CFG as JAX_PCW_CFG
from xivo_tpu.sim.stream import build_pcw_stream as jax_stream
from xivo_tpu_torch import interop
from xivo_tpu_torch.filter.config import config_from_json
from xivo_tpu_torch.filter.layout import Dims
from xivo_tpu_torch.map.p3p import N_HYPS
from xivo_tpu_torch.runner import inputs_to_device, run_batch_mapped
from xivo_tpu_torch.sim.configs import PCW_CFG

torch.set_num_threads(2)
FRAMES = 60
SEEDS = (1, 2)
CAPACITY = 256
MAPPER = dict(use_mapper=True, lc_keyframe_every=8, lc_min_age_frames=20,
              lc_nn_dist_thresh=5, lc_min_matches=5, X_Vsb=(0.9, 0.0, 0.45),
              map_merge_on_retire=False)
STREAM = dict(noise_px=0.25, motion="loop", n_points=600)
POSE_TOL = 1e-7


def mapped_cfgs(dtype="float64"):
    return (jax_config_from_json(JAX_PCW_CFG, dims=JaxDims(*TINY),
                                 dtype=dtype, **SLICE, **MAPPER),
            config_from_json(PCW_CFG, dims=Dims(*TINY), dtype=dtype,
                             **SLICE, **MAPPER))


def reference_draws(keys, n, dtype):
    """The uniforms close_loop draws from each sequence's key (B, 2):
    (the next keys, draws (B, N_HYPS, n))."""
    def one(key):
        key, sub = jax.random.split(key)
        hyp = jax.random.split(sub, N_HYPS)
        return key, jax.vmap(lambda k: jax.random.uniform(k, (n,), dtype))(
            hyp)
    nxt, u = jax.vmap(one)(keys)
    return nxt, np.asarray(u)


def batched_map(capacity, B):
    """B empty reference maps. The counters start as int64, the dtype
    JAX's sums give them after a frame with x64 on, so that a jitted
    step over the map is traced once."""
    ms = jax_init_map(capacity, dtype=jnp.float64)
    ms = ms._replace(**{k: getattr(ms, k).astype(jnp.int64)
                        for k in ("write_ptr", "count", "n_merged")})
    return jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape).copy(),
                        ms)


def run_reference(step, js, jms, frames, n):
    """Frame by frame: the draws of each frame from the key, the step,
    and a check that the step consumed its key as rebuilt here."""
    draws, outs, lcs = [], [], []
    for t in range(frames):
        nxt, u = reference_draws(js.key, n, jnp.float64)
        draws.append(u)
        js, jms, o, n_lc = step(js, jms, t)
        np.testing.assert_array_equal(np.asarray(js.key), np.asarray(nxt))
        outs.append(o)
        lcs.append(np.asarray(n_lc))
    jo = jax.tree.map(lambda *x: np.stack(x, 1), *outs)
    return js, jms, jo, np.stack(lcs, 1), np.stack(draws, 1)


def check_maps(jms, tms):
    a, b = jax.tree.map(np.asarray, jms), interop.map_to_numpy(tms)
    for name in ("desc", "gid", "epoch", "valid", "write_ptr", "count",
                 "n_merged"):
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name),
                                      err_msg=name)
    np.testing.assert_allclose(b.Xs, a.Xs, rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(b.cov, a.cov, rtol=0, atol=1e-9)


def check_outputs(jo, to):
    for name in jo._fields:
        a, b = np.asarray(getattr(jo, name)), getattr(to, name).numpy()
        if np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=POSE_TOL,
                                       err_msg=name)


@pytest.fixture(scope="module")
def pcw_runs():
    jc, tc = mapped_cfgs()
    kw = dict(total_time=FRAMES * 0.05, **STREAM)
    streams = [jax_stream(jc, seed=sd, **kw) for sd in SEEDS]
    fi = type(streams[0][0])(*(np.stack(x) for x in
                               zip(*[f for f, _ in streams])))
    B = len(SEEDS)
    js = jax_batch_states(jc, B)._replace(
        last_gyro=jnp.asarray(np.stack([g["gyro0"] for _, g in streams])),
        last_accel=jnp.asarray(np.stack([g["accel0"] for _, g in streams])))
    jms = batched_map(CAPACITY, B)
    ts = interop.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    tms = interop.map_from_numpy(jax.tree.map(np.asarray, jms), "cpu")
    vstep = jax.jit(jax.vmap(lambda s, ms, *a: jax_vio_frame_mapped(
        jc, s, ms, *a)))
    jfi = jax.tree.map(jnp.asarray, tuple(fi))
    js, jms, jo, jlc, draws = run_reference(
        lambda s, ms, t: vstep(s, ms, *(a[:, t] for a in jfi)), js, jms,
        FRAMES, jc.dims.n_features)
    port = run_batch_mapped(tc, ts, tms, inputs_to_device(fi, "cpu"),
                            uniforms=torch.from_numpy(draws))
    gt = np.stack([g["Tsb"] for _, g in streams])
    return (js, jms, jo, jlc), port, gt


def test_mapped_frames_match_reference(pcw_runs):
    (js, jms, jo, jlc), (ts, tms, to, tlc), gt = pcw_runs
    np.testing.assert_array_equal(tlc.numpy(), jlc)
    check_outputs(jo, to)
    check_maps(jms, tms)
    # the run did real work: loops closed from frame ~27 on, the map
    # filled (with repeated keyframe entries: ties in the Hamming search)
    assert int(jlc.sum()) > 50, jlc.sum(1)
    assert int(np.asarray(jms.count).min()) > 0
    err = np.linalg.norm(to.Tsb.numpy() - gt, axis=-1)
    assert float(err.max()) < 0.15


def test_mapped_state_matches_reference(pcw_runs):
    from test_torch_pipeline import _walk
    (js, _, _, _), (ts, _, _, _), _ = pcw_runs
    for path, d in _walk(interop.state_to_numpy(ts),
                         jax.tree.map(np.asarray, js)):
        assert d <= 1e-7, (path, d)


def test_retire_with_fusion_on_the_live_state(pcw_runs):
    """retire_features with fusion on, after the run: the map's entries
    fuse with the re-retired in-state and subfilter rows (not the gauge
    rows, see the module docstring)."""
    from xivo_tpu.map.mapper import retire_features as jax_retire
    from xivo_tpu_torch.filter.state import FS_GAUGE
    from xivo_tpu_torch.map.mapper import retire_features
    (js, jms, _, _), (ts, tms, _, _), _ = pcw_runs
    jc, tc = mapped_cfgs()
    jc = dataclasses.replace(jc, map_merge_on_retire=True)
    tc = dataclasses.replace(tc, map_merge_on_retire=True)
    fr = ts.features
    mask = fr.active & (fr.status != FS_GAUGE)
    jstate = jax.tree.map(jnp.asarray, interop.state_to_numpy(ts))
    jstate = js._replace(**jstate._asdict())
    jmap = jax.tree.map(jnp.asarray, interop.map_to_numpy(tms))
    ref = jax.vmap(lambda s, ms, m: jax_retire(jc, s, ms, m))(
        jstate, jmap, jnp.asarray(mask.numpy()))
    out = retire_features(tc, ts, tms, mask)
    check_maps(ref, out)
    merged = np.asarray(ref.n_merged) - np.asarray(jmap.n_merged)
    assert int(merged.min()) > 0, merged

