"""The port's image-mode mapped frame step against the JAX package, on
the CPU: ``vio_frame_image_mapped`` over 8 frames of two rendered
sequences (``tests/test_torch_image_pipeline.py``'s config and stream,
tiny Dims, float64, B = 2) with the mapper on: keyframes every 2 frames,
entries eligible for closure after 2, a 64-entry map. The RANSAC draws are
the reference's, rebuilt from its key (``test_torch_mapped_pipeline``).
Closure rows, map counts, descriptors, epochs and validity exactly; poses
within 5e-7 m (the image path's tolerance, see
``test_torch_image_pipeline``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_image_pipeline import exact_crops, image_cfgs, port_stream
from test_torch_mapped_pipeline import SEEDS, batched_map, run_reference
from xivo_tpu.frontend import init_frontend as jax_init_frontend
from xivo_tpu.map.integration import (
    vio_frame_image_mapped as jax_vio_frame_image_mapped)
from xivo_tpu.runner import batch_states as jax_batch_states
from xivo_tpu_torch import interop
from xivo_tpu_torch.runner import image_inputs_to_device, run_batch_image_mapped

torch.set_num_threads(2)

IMG_FRAMES = 8


def test_vio_frame_image_mapped_matches_reference():
    jc, tc = image_cfgs()
    over = dict(use_mapper=True, lc_keyframe_every=2, lc_min_age_frames=2,
                lc_nn_dist_thresh=30)
    jc, tc = dataclasses.replace(jc, **over), dataclasses.replace(tc, **over)
    streams = [port_stream(tc, IMG_FRAMES, sd) for sd in SEEDS]
    fi = type(streams[0][0])(*(np.stack(x) for x in
                               zip(*[f for f, _ in streams])))
    B = len(SEEDS)
    # next_fid as int64: the dtype the step gives it with x64 on, so that
    # the jitted step is traced once
    js = jax_batch_states(jc, B)._replace(
        last_gyro=jnp.asarray(np.stack([g["gyro0"] for _, g in streams])),
        last_accel=jnp.asarray(np.stack([g["accel0"] for _, g in streams])))
    js = js._replace(next_fid=js.next_fid.astype(jnp.int64))
    jf = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape).copy(),
                      jax_init_frontend(jc))
    jms = batched_map(64, B)
    ts = interop.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    tf = interop.frontend_from_numpy(jax.tree.map(np.asarray, jf), "cpu")
    tms = interop.map_from_numpy(jax.tree.map(np.asarray, jms), "cpu")
    vstep = jax.jit(jax.vmap(lambda s, f, ms, *a: jax_vio_frame_image_mapped(
        jc, s, f, ms, *a)))
    holder = {"f": jf}

    def step(s, ms, t):
        s, holder["f"], ms, o, n = vstep(
            s, holder["f"], ms, *(jnp.asarray(a[:, t]) for a in fi))
        return s, ms, o, n

    with exact_crops():
        js, jms, jo, jlc, draws = run_reference(step, js, jms, IMG_FRAMES,
                                                jc.dims.n_features)
    _, _, tms, to, tlc = run_batch_image_mapped(
        tc, ts, tf, tms, image_inputs_to_device(fi, "cpu"),
        uniforms=torch.from_numpy(draws))
    np.testing.assert_array_equal(tlc.numpy(), jlc)
    for name in jo._fields:
        a, b = np.asarray(getattr(jo, name)), getattr(to, name).numpy()
        if np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=5e-7, err_msg=name)
    a, b = jax.tree.map(np.asarray, jms), interop.map_to_numpy(tms)
    for name in ("desc", "valid", "count", "n_merged", "epoch"):
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name),
                                      err_msg=name)
    assert int(a.count.min()) > 0
