"""The port's descriptors (``frontend/descriptors.py``) against the JAX
package, on the CPU.

* The pattern tables (the orientation disc, the FREAK retina and pairs,
  the field ring, the BRISK pattern and its short and long pairs) are
  built by the same numpy code and are equal byte for byte.
* Every descriptor kind through the factory (``extract``: BRIEF, ORB,
  FREAK, BRISK) at 32 keypoints of a smoothed textured image in float64:
  the words are equal; so are the centroid orientations to 1e-12 rad.
* In float32, on frames of the image tests' dot-rendered stream at the
  tracker's own picks (oFAST, 128 of them), as the MATCH tracker feeds
  them: the words are equal, for every kind.
* The reference's rotation-invariance tests (``tests/
  test_tracker_extras.py::test_orb_rotation_invariance`` and
  ``test_brisk_rotation_invariance_and_repeatability``) on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xivo_tpu.frontend import descriptors as jdesc
from xivo_tpu.frontend import fast as jfast
from xivo_tpu.frontend import image as jimage
from xivo_tpu_torch.frontend import brief, descriptors, image

from test_torch_frontend import smooth_texture
from test_torch_image_pipeline import (STREAM, exact_crops, image_cfgs,
                                       reference_stream)

torch.set_num_threads(2)
TABLES = ("_DISC", "_RETINA", "_FREAK_PAIRS", "_RING4", "_BRISK",
          "_BRISK_SHORT", "_BRISK_LONG")


@pytest.mark.parametrize("name", TABLES)
def test_pattern_tables_are_the_references(name):
    a, b = getattr(jdesc, name), getattr(descriptors, name)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def texture_case():
    rng = np.random.default_rng(11)
    img = np.array(jimage.blur5(jnp.asarray(smooth_texture(rng, 64, 80))))
    xy = np.stack([rng.uniform(4.0, 76.0, 32), rng.uniform(4.0, 60.0, 32)],
                  axis=1)
    return img, xy


@pytest.mark.parametrize("kind", sorted(descriptors.KINDS))
def test_extract_matches_reference_in_float64(kind):
    img, xy = texture_case()
    k = descriptors.KINDS[kind]
    assert k == jdesc.KINDS[kind]
    with exact_crops():
        ref = np.asarray(jax.vmap(lambda p: jdesc.extract(
            k, jnp.asarray(img), p))(jnp.asarray(xy)))
    got = descriptors.extract(k, torch.from_numpy(img)[None],
                              torch.from_numpy(xy)[None])[0]
    assert got.dtype == torch.int64 and got.shape == (32, 8)
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
    # the words differ from keypoint to keypoint
    assert len({tuple(w) for w in got.tolist()}) == 32


def test_orientation_matches_reference():
    img, xy = texture_case()
    with exact_crops():
        ref = np.asarray(jax.vmap(lambda p: jdesc.orientation(
            jnp.asarray(img), p))(jnp.asarray(xy)))
    got = descriptors.orientation(torch.from_numpy(img)[None],
                                  torch.from_numpy(xy)[None])[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


def test_extract_matches_reference_on_the_tracker_frames_in_float32():
    jc, _ = image_cfgs()
    frames = reference_stream(jc, 3, 1, **STREAM)[0]["image"]
    kinds = sorted(descriptors.KINDS.values())
    for im in frames[1:]:
        sm = jimage.blur5(jnp.asarray(im))
        sc = jfast.nms3(jfast.ofast_score(jnp.asarray(im), 15.0))
        xy, _, ok = jfast.select_topk(sc, 128, 8, jnp.zeros((1, 2)),
                                      jnp.zeros((1,), bool), 15)
        assert int(ok.sum()) > 40 and xy.dtype == jnp.float32
        with exact_crops():
            ref = [np.asarray(jax.jit(jax.vmap(
                lambda p, k=k: jdesc.extract(k, sm, p)))(xy)) for k in kinds]
        tsm = torch.from_numpy(np.array(sm))[None]
        txy = torch.from_numpy(np.array(xy))[None]
        for k, r in zip(kinds, ref):
            np.testing.assert_array_equal(
                descriptors.extract(k, tsm, txy)[0].numpy(),
                r.astype(np.int64), err_msg=str(k))


def rotated_image(img, center, theta):
    """I2(x) = I1(R^T (x - c) + c), sampled bilinearly (the reference
    test's ``_rotated_image``, with the reference's sampler)."""
    H, W = img.shape
    ys, xs = np.mgrid[0:H, 0:W]
    pts = np.stack([xs.ravel(), ys.ravel()], axis=1).astype(img.dtype)
    c, s = np.cos(-theta), np.sin(-theta)
    R = np.array([[c, -s], [s, c]], img.dtype)
    src = (pts - center) @ R.T + center
    return np.array(jimage.bilinear(jnp.asarray(img), jnp.asarray(src))
                    ).reshape(H, W)


@pytest.mark.parametrize("seed,kinds", [(3, ("orb", "freak")),
                                        (4, ("brisk",))])
def test_steered_descriptors_survive_rotation(seed, kinds):
    """A 35-degree in-plane rotation breaks plain BRIEF; the steered
    descriptors keep under 0.6 of its distance and equal words on the
    image itself."""
    rng = np.random.default_rng(seed)
    img = image.blur5(image.blur5(torch.from_numpy(
        rng.uniform(0, 255, (96, 96)))))
    c = np.array([48.0, 48.0])
    img2 = torch.from_numpy(rotated_image(img.numpy(), c, np.pi * 35 / 180))
    xy = torch.from_numpy(c)[None, None]
    both = torch.stack([img, img2])

    def dist(k):
        d = descriptors.extract(descriptors.KINDS[k], both, xy.expand(2, 1, 2))
        return int(brief.hamming(d[0], d[1])[0])
    d_brief = dist("brief")
    for k in kinds:
        assert dist(k) < 0.6 * max(d_brief, 1), (k, dist(k), d_brief)
        d = descriptors.extract(descriptors.KINDS[k], img[None], xy)
        assert int(brief.hamming(d, d)[0, 0]) == 0
