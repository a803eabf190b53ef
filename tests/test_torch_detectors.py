"""The port's corner detectors against the JAX package, on the CPU.

* The five detector scores of the reference's factory (FAST's sibling
  AGAST-7/12d, Shi-Tomasi/GFTT, Harris, oFAST, BRISK) on a textured
  64 x 80 image pair, in float64 and float32: within 1e-10 in float64
  and 1e-6 of the map's largest score in float32 (the reference's
  ``jnp.sqrt`` in Shi-Tomasi is one ulp off the correctly rounded one on
  some pixels; every other score is equal bit for bit), and the 3 x 3
  non-maximum suppression with the top-k pick (``select_topk``) picks
  the same positions with the same scores.
* The tracker's detector factory maps each name to the reference's
  score, ORB and OFAST to oFAST, and an unknown name to FAST.
* The reference's own detector tests (``tests/test_tracker_extras.py::
  test_new_detector_scores_fire_on_corners`` and ``tests/
  test_frontend.py::test_agast_detector_fires_on_texture``) on the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xivo_tpu.frontend import fast as jfast
from xivo_tpu_torch.frontend import fast
from xivo_tpu_torch.frontend.tracker import _detect_score

from test_torch_frontend import smooth_texture
from test_torch_pipeline import torch_cfg

torch.set_num_threads(2)
SCORES = ("agast_score", "shi_tomasi_score", "harris_score", "ofast_score",
          "brisk_score")
TOL = {"float64": 1e-10, "float32": 1e-6}


def textured_pair(dtype):
    """Two textured 64 x 80 images (0-255), the second with a bright
    square planted so that the segment tests fire at its corners."""
    rng = np.random.default_rng(5)
    imgs = np.stack([smooth_texture(rng, 64, 80), smooth_texture(rng, 64, 80)])
    imgs[1, 20:36, 30:50] = 250.0
    return imgs.astype(dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", SCORES)
def test_detector_score_and_picks_match_reference(name, dtype):
    imgs = textured_pair(dtype)
    ref = np.asarray(jax.vmap(getattr(jfast, name))(jnp.asarray(imgs)))
    got = getattr(fast, name)(torch.from_numpy(imgs)).numpy()
    assert got.dtype == ref.dtype == np.dtype(dtype)
    scale = max(np.abs(ref).max(), 1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL[dtype] * scale)
    assert (ref > 0).sum() > 50       # the map has corners to pick from

    jnms = jax.vmap(jfast.nms3)(jnp.asarray(ref))
    k, margin, mask = 32, 6, 9
    jxy, jsc, jok = jax.vmap(lambda s: jfast.select_topk(
        s, k, margin, jnp.zeros((1, 2), jnp.float32), jnp.zeros((1,), bool),
        mask))(jnms)
    txy, tsc, tok = fast.select_topk(
        fast.nms3(torch.from_numpy(got)), k, margin,
        torch.zeros((2, 1, 2)), torch.zeros((2, 1), dtype=torch.bool), mask)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(txy.numpy(), np.asarray(jxy))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=0,
                               atol=TOL[dtype] * scale)
    assert tok.sum() > k // 2


def test_ofast_takes_the_harris_minimum_per_image():
    """oFAST shifts Harris by each image's own minimum, never the batch's:
    an image's scores do not change with what else is in the batch."""
    imgs = torch.from_numpy(textured_pair("float64"))
    both = fast.ofast_score(imgs)
    for b in range(2):
        np.testing.assert_array_equal(both[b].numpy(),
                                      fast.ofast_score(imgs[b:b + 1])[0])


@pytest.mark.parametrize("odd", [(63, 80), (64, 79)])
def test_brisk_on_odd_sizes_matches_reference(odd):
    """The half scale is a 2 x 2 mean of the even part; its score is
    repeated back up and zero-padded on the odd row or column."""
    img = textured_pair("float64")[1, :odd[0], :odd[1]]
    ref = np.asarray(jfast.brisk_score(jnp.asarray(img)))
    got = fast.brisk_score(torch.from_numpy(img)[None])[0].numpy()
    np.testing.assert_array_equal(got, ref)
    assert not got[-1].any() if odd[0] % 2 else not got[:, -1].any()


@pytest.mark.parametrize("name,fn", [
    ("FAST", "fast_score"), ("AGAST", "agast_score"),
    ("GFTT", "shi_tomasi_score"), ("ORB", "ofast_score"),
    ("OFAST", "ofast_score"), ("BRISK", "brisk_score"),
    ("SIFT", "fast_score")])
def test_detector_factory(name, fn):
    cfg = dataclasses.replace(torch_cfg(), detector=name)
    img = torch.from_numpy(textured_pair("float64"))
    want = getattr(fast, fn)(img) if fn == "shi_tomasi_score" \
        else getattr(fast, fn)(img, cfg.fast_threshold)
    np.testing.assert_array_equal(_detect_score(cfg, img).numpy(),
                                  want.numpy())


def test_new_detector_scores_fire_on_corners():
    """oFAST and BRISK responses peak at a bright square's corner and stay
    zero on its flat interior (``tests/test_tracker_extras.py:251``)."""
    img = np.zeros((64, 64), np.float32)
    img[16:48, 16:48] = 200.0
    img += np.random.default_rng(0).normal(0, 1.0, img.shape).astype(
        np.float32)
    corners = np.array([[16, 16], [16, 47], [47, 16], [47, 47]])
    for fn in (fast.ofast_score, fast.brisk_score):
        sc = fn(torch.from_numpy(img)[None], 20.0)[0].numpy()
        yx = np.unravel_index(sc.argmax(), sc.shape)
        d = np.abs(corners - np.asarray(yx)[None, :]).max(axis=1).min()
        assert d <= 3, (fn, yx)
        assert sc[28:36, 28:36].max() == 0.0


def test_agast_detector_fires_on_texture():
    """AGAST-7/12d fires at a planted blob's corners and not on a flat
    image (``tests/test_frontend.py:125``)."""
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 60, (64, 64))
    img[30:34, 30:34] = 220.0
    sc = fast.nms3(fast.agast_score(torch.from_numpy(img)[None], 20.0))[0]
    ys, xs = np.nonzero(sc.numpy() > 0)
    assert len(ys) > 0
    assert (np.abs(ys - 32) <= 4).any() and (np.abs(xs - 32) <= 4).any()
    assert float(fast.agast_score(torch.zeros((1, 64, 64)), 20.0).max()) \
        == 0.0
