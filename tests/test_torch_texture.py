"""The port's textured renderer (``sim/texture.py``) against the JAX
package's, on the CPU.

* ``pixel_rays`` through the pinhole and the equidistant lens at 64 x
  48: within 1e-12 (the reference unprojects with its JAX camera model,
  the port with its own, both in float64).
* One ``TexturedBoxWorld.render`` with markers, blur and sensor noise
  from the same seed: within 1e-3 grey levels.
* ``build_image_stream(world=)`` renders the room along the stream's
  trajectory through a config's lens (``world_for``), and the LK tracker
  holds tracks on it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xivo_tpu.cam import models as jcam
from xivo_tpu.sim import texture as jtexture
from xivo_tpu_torch.cam import models as cam
from xivo_tpu_torch.sim import texture

from test_torch_image_pipeline import image_cfgs

torch.set_num_threads(2)
LENSES = {
    "pinhole": dict(model="pinhole", rows=48, cols=64, fx=50.0, fy=52.0,
                    cx=31.5, cy=24.0),
    "equidistant": dict(model="equidistant", rows=48, cols=64, fx=50.0,
                        fy=52.0, cx=31.5, cy=24.0, k0=0.0034, k1=0.0008,
                        k2=-0.0007, k3=0.0001)}


def both_intrinsics(lens):
    jk, ji, _ = jcam.intrinsics_from_cfg(LENSES[lens], dtype=jnp.float64)
    tk, ti, _ = cam.intrinsics_from_cfg(LENSES[lens])
    assert jk == tk
    return tk, np.asarray(ji), ti.numpy()


@pytest.mark.parametrize("lens", sorted(LENSES))
def test_pixel_rays_match_reference(lens):
    kind, ji, ti = both_intrinsics(lens)
    ref = jtexture.pixel_rays(kind, ji, 64, 48)
    got = texture.pixel_rays(kind, ti, 64, 48)
    assert got.shape == (48, 64, 3) and got.dtype == np.float64
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-15)


def test_render_matches_reference():
    kind, ji, ti = both_intrinsics("equidistant")
    kw = dict(half_extents=(4.0, 4.0, 2.5), texture_scale=4.0, octaves=5,
              seed=3, markers=True)
    a = jtexture.TexturedBoxWorld(kind, ji, 64, 48, **kw)
    b = texture.TexturedBoxWorld(kind, ti, 64, 48, **kw)
    R = np.asarray([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    T = np.asarray([0.4, -0.3, 0.2])
    ia = a.render(R, T, exposure=1.05, blur_px=0.6, noise_std=2.0,
                  rng=np.random.default_rng(1))
    ib = b.render(R, T, exposure=1.05, blur_px=0.6, noise_std=2.0,
                  rng=np.random.default_rng(1))
    assert ib.dtype == np.float32 and ib.shape == (48, 64)
    np.testing.assert_allclose(ib, ia, rtol=0, atol=1e-3)
    assert ib.std() > 10.0          # textured, not flat


def test_textured_stream_holds_tracks():
    from xivo_tpu_torch.filter.state import TS_TRACKED
    from xivo_tpu_torch.frontend.tracker import tracker_only_frame
    from xivo_tpu_torch.runner import batch_frontend_states, batch_states
    from xivo_tpu_torch.sim.image_stream import build_image_stream
    _, tc = image_cfgs(detector="GFTT", descriptor="brisk")
    fi, _ = build_image_stream(tc, total_time=0.24,
                               world=texture.world_for(tc))
    assert fi.image.shape == (4, 240, 320)
    s, f = batch_states(tc, 1, device="cpu"), \
        batch_frontend_states(tc, 1, device="cpu")
    for t in range(4):
        s, f = tracker_only_frame(tc, s, f,
                                  torch.from_numpy(fi.image[t:t + 1]))
    assert int((s.features.track == TS_TRACKED).sum()) > 10
