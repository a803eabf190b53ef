"""The port's front-end-only step (``tracker_only_frame``, the
feature_tracker_only app: track and detect, no filter) against the JAX
package, on the CPU: frames 50-59 of two rendered sequences at tiny Dims
in float64, with the setup and tolerances of
``tests/test_torch_image_pipeline.py`` (its module docstring says why the
reference's run takes the exact form of its selection matmuls). A tight
displacement gate drops tracks; without a filter to consume them,
dropped rows are freed at the start of the next frame, so slots recycle.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_image_pipeline import (SEEDS, check_tables, exact_crops,
                                       image_cfgs, port_stream)
from xivo_tpu.frontend import init_frontend as jax_init_frontend
from xivo_tpu.frontend import tracker_only_frame as jax_tracker_only
from xivo_tpu.runner import batch_states as jax_batch_states
from xivo_tpu_torch import interop
from xivo_tpu_torch.frontend.tracker import tracker_only_frame

FRAMES = 10


@pytest.fixture(scope="module")
def runs():
    jc, tc = image_cfgs(max_pixel_displacement=1.5)
    # frames 50-59, where the camera moves by a few pixels a frame
    images = np.stack([port_stream(tc, 50 + FRAMES, sd)[0].image[50:]
                       for sd in SEEDS])
    B = len(SEEDS)
    js = jax_batch_states(jc, B)
    # next_fid as int64: the dtype the step gives it with x64 on, so that
    # the jitted step is traced once
    js = js._replace(next_fid=js.next_fid.astype(jnp.int64))
    jf = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape).copy(),
                      jax_init_frontend(jc))
    ts = interop.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    tf = interop.frontend_from_numpy(jax.tree.map(np.asarray, jf), "cpu")
    step = jax.jit(jax.vmap(lambda s, f, im: jax_tracker_only(jc, s, f, im)))
    counts = []
    with exact_crops():
        for t in range(FRAMES):
            js, jf = step(js, jf, jnp.asarray(images[:, t]))
            ts, tf = tracker_only_frame(tc, ts, tf, torch.from_numpy(
                np.ascontiguousarray(images[:, t])))
            counts.append((np.asarray(js.features.active).sum(-1),
                           ts.features.active.sum(-1).numpy(),
                           np.asarray(js.next_fid), ts.next_fid.numpy()))
    return (jax.tree.map(np.asarray, js), jax.tree.map(np.asarray, jf),
            ts, tf, counts)


def test_tracker_only_frame_matches_reference(runs):
    js, jf, ts, tf, counts = runs
    for t, (ja, ta, jn, tn) in enumerate(counts):
        np.testing.assert_array_equal(ta, ja, err_msg=f"frame {t}")
        np.testing.assert_array_equal(tn, jn, err_msg=f"frame {t}")
    check_tables(js, ts, jf, tf)
    # tracks were kept, and new ones spawned into recycled slots
    assert int(counts[-1][0].min()) > 0
    assert int(np.asarray(js.next_fid).min()) > int(counts[0][2].max())
