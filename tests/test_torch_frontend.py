"""The port's image front end against the JAX package, on the CPU.

Float64, numpy-seeded inputs, the same numbers into both packages:
the stencils (``blur5``, pyramids on odd sizes, Scharr), FAST with its
non-maximum suppression and the masked top-k pick, patch crops and
in-patch bilinear samples near the borders, BRIEF descriptors with their
Hamming distances, and pyramidal LK (one level and the whole pyramid)
against the reference's jnp path. Tolerance 1e-10 on the numbers (the
same float64 arithmetic, sums in another order); descriptor words,
flags and picks exactly. The cases of ``tests/test_frontend.py`` run on
the port too (the LK flow recovery and the occupancy mask), at their own
bounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import zoom

from xivo_tpu.frontend import brief as jbrief
from xivo_tpu.frontend import fast as jfast
from xivo_tpu.frontend import image as jimage
from xivo_tpu.frontend import lk as jlk
from xivo_tpu_torch.frontend import brief, fast, image, lk
from xivo_tpu_torch.ops import lk as lk_ops

torch.set_num_threads(2)
TOL = 1e-10


def t(a):
    return torch.from_numpy(np.array(a))


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=tol)


def smooth_texture(rng, H=128, W=160, octaves=4):
    """Random multi-scale texture with plenty of gradients (0-255)."""
    img = np.zeros((H, W))
    for o in range(octaves):
        h, w = H // (2 ** o) + 2, W // (2 ** o) + 2
        z = zoom(rng.standard_normal((h, w)), (H / h, W / w), order=3)
        img += z[:H, :W] * (2.0 ** o)
    return (img - img.min()) / (img.max() - img.min()) * 255.0


def dots(rng, H, W, n=40):
    """Bright squares and dots on noise: FAST corners, some with equal
    scores."""
    img = rng.uniform(0.0, 30.0, (H, W))
    for _ in range(n):
        y, x = rng.integers(4, H - 4), rng.integers(4, W - 4)
        r = rng.integers(1, 4)
        img[y - r:y + r + 1, x - r:x + r + 1] = rng.uniform(120.0, 250.0)
    return img


def test_blur_and_scharr_match_reference():
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0.0, 255.0, (2, 37, 53))
    close(image.blur5(t(imgs)), jax.vmap(jimage.blur5)(jnp.asarray(imgs)))
    close(image.blur3(t(imgs)), jax.vmap(jimage.blur3)(jnp.asarray(imgs)))
    gx, gy = image.scharr(t(imgs))
    jgx, jgy = jax.vmap(jimage.scharr)(jnp.asarray(imgs))
    close(gx, jgx)
    close(gy, jgy)


@pytest.mark.parametrize("shape", [(37, 53), (64, 64), (41, 30)])
def test_build_pyramid_on_odd_sizes(shape):
    rng = np.random.default_rng(1)
    img = rng.uniform(0.0, 255.0, shape)
    got = image.build_pyramid(t(img)[None], 4)
    ref = jimage.build_pyramid(jnp.asarray(img), 4)
    h, w = shape
    for g, r in zip(got, ref):
        assert g.shape == (1, h, w) == (1,) + r.shape
        close(g[0], r)
        h, w = (h + 1) // 2, (w + 1) // 2


def test_fast_score_and_nms_match_reference():
    rng = np.random.default_rng(2)
    imgs = np.stack([dots(rng, 48, 64), smooth_texture(rng, 48, 64)])
    score = fast.fast_score(t(imgs), 15.0)
    jscore = jax.vmap(lambda x: jfast.fast_score(x, 15.0))(jnp.asarray(imgs))
    close(score, jscore, 0.0)
    assert float(score.max()) > 0.0
    close(fast.nms3(score), jax.vmap(jfast.nms3)(jscore), 0.0)


def _topk_both(score, k, margin, occ_xy, occ_valid, mask_size):
    got = fast.select_topk(t(score), k, margin, t(occ_xy), t(occ_valid),
                           mask_size)
    ref = jax.vmap(lambda s, o, v: jfast.select_topk(
        s, k, margin, o, v, mask_size))(jnp.asarray(score),
                                        jnp.asarray(occ_xy),
                                        jnp.asarray(occ_valid))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    return got


def test_select_topk_ties_and_occupancy_match_reference():
    # the four identical squares of tests/test_frontend.py give equal
    # FAST scores: the pick keeps the reference's order among ties
    img = np.zeros((64, 64))
    for (y, x) in [(16, 16), (16, 48), (48, 16), (48, 48)]:
        img[y - 3:y + 4, x - 3:x + 4] = 200.0
    score = jfast.nms3(jfast.fast_score(jnp.asarray(img), 20.0))
    score = np.stack([np.asarray(score)] * 2)
    occ = np.array([[[16.0, 16.0], [3.0, 70.0]], [[0.0, 0.0], [48.0, 47.6]]])
    valid = np.array([[True, True], [False, True]])
    xy, vals, ok = _topk_both(score, 8, 4, occ, valid, 15)
    assert int(ok[0].sum()) >= 3 and int(ok[1].sum()) >= 3
    assert len(set(vals[0, :8].tolist())) < 8      # ties were there

    rng = np.random.default_rng(3)
    imgs = np.stack([dots(rng, 60, 80, 60), dots(rng, 60, 80, 60)])
    score = np.asarray(jax.vmap(lambda x: jfast.nms3(
        jfast.fast_score(x, 15.0)))(jnp.asarray(imgs)))
    occ = rng.uniform(-5.0, 85.0, (2, 32, 2))
    valid = rng.uniform(size=(2, 32)) < 0.5
    _topk_both(score, 64, 8, occ, valid, 15)


def test_patch_crops_and_samples_near_borders_match_reference():
    rng = np.random.default_rng(4)
    imgs = rng.uniform(0.0, 255.0, (2, 40, 50))
    # keypoints inside, on and beyond the borders
    xy = np.concatenate([rng.uniform(-6.0, 56.0, (2, 20, 1)),
                         rng.uniform(-6.0, 46.0, (2, 20, 1))], axis=-1)
    xy[:, :4] = [[0.2, 0.4], [49.7, 39.6], [-3.0, 20.0], [25.5, 42.5]]
    S = 11
    cx = np.round(xy[..., 0]).astype(np.int64)
    cy = np.round(xy[..., 1]).astype(np.int64)
    got = image.extract_patch(t(imgs), t(cx), t(cy), S)
    ref = jax.vmap(jax.vmap(lambda c, a, b: jimage.extract_patch(c, a, b, S),
                            in_axes=(None, 0, 0)))(
        jnp.asarray(imgs), jnp.asarray(cx, jnp.int32),
        jnp.asarray(cy, jnp.int32))
    close(got, ref, 0.0)
    rel = rng.uniform(-4.0, 4.0, (30, 2))
    got = image.sample_rel(t(imgs), t(xy), t(rel), S)
    ref = jax.vmap(jax.vmap(lambda c, p: jimage.sample_rel(
        c, p, jnp.asarray(rel), S), in_axes=(None, 0)))(
        jnp.asarray(imgs), jnp.asarray(xy))
    close(got, ref)


def test_brief_and_hamming_match_reference():
    rng = np.random.default_rng(5)
    np.testing.assert_array_equal(brief.PATTERN, jbrief.PATTERN)
    imgs = np.stack([smooth_texture(rng), smooth_texture(rng)])
    sm = image.blur5(t(imgs))
    jsm = jax.vmap(jimage.blur5)(jnp.asarray(imgs))
    xy = rng.uniform([-5.0, -5.0], [165.0, 133.0], (2, 24, 2))
    xy[:, :3] = [[2.0, 2.0], [158.5, 126.9], [80.0, 64.0]]
    d = brief.extract(sm, t(xy))
    jd = np.asarray(jax.vmap(jax.vmap(jbrief.extract, in_axes=(None, 0)))(
        jsm, jnp.asarray(xy)))
    assert d.dtype == torch.int64 and d.shape == (2, 24, 8)
    np.testing.assert_array_equal(d.numpy().astype(np.uint32), jd)
    assert int(d.max()) < 2 ** 32 and int(d.min()) >= 0
    other = d.flip(1)
    np.testing.assert_array_equal(
        brief.hamming(d, other).numpy(),
        np.asarray(jbrief.hamming(jnp.asarray(jd), jnp.asarray(jd[:, ::-1]))))
    np.testing.assert_array_equal(
        brief.hamming_matrix(d, other).numpy(),
        np.asarray(jax.vmap(jbrief.hamming_matrix)(
            jnp.asarray(jd), jnp.asarray(jd[:, ::-1]))))
    # all 256 bits counted: the distance to the complement is 256
    full = (2 ** 32 - 1) ^ d
    assert int(brief.hamming(d, full).min()) == 256


def test_patch_stencils_and_window_match_reference():
    rng = np.random.default_rng(6)
    p = rng.uniform(0.0, 255.0, (2, 5, 31, 31))
    gx, gy = image.scharr(t(p))          # the port's in-patch gradients
    jgx, jgy = jax.vmap(jlk._scharr_patches)(jnp.asarray(p))
    close(gx, jgx)
    close(gy, jgy)
    # starts inside, on the clip edges and beyond them
    start = rng.uniform(-2.0, 18.0, (2, 5, 2))
    start[0, :3] = [[0.0, 0.0], [15.9991, 15.9991], [15.2, 0.7]]
    got = lk_ops.window_plain(t(p), t(start), 15)
    ref = jax.vmap(lambda a, b: jlk._patch_bilinear(a, b, 15))(
        jnp.asarray(p), jnp.asarray(start))
    close(got, ref)


def _lk_case(seed, B=2, N=24, H=96, W=128, levels=3, flow=(2.6, -1.7)):
    """Two textured frames per sequence, the second moved by `flow` plus
    noise, and N tracks (some invalid, some near the border)."""
    rng = np.random.default_rng(seed)
    img0 = np.stack([smooth_texture(rng, H, W) for _ in range(B)])
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    img1 = np.stack([np.asarray(jimage.bilinear(
        jnp.asarray(im), jnp.stack([xs + flow[0], ys + flow[1]], -1)))
        for im in img0]) + rng.normal(0.0, 1.0, (B, H, W))
    pts = rng.uniform([4.0, 4.0], [W - 4.0, H - 4.0], (B, N, 2))
    guesses = pts + rng.normal(0.0, 0.7, (B, N, 2))
    valid = rng.uniform(size=(B, N)) < 0.85
    return img0, img1, pts, guesses, valid


def test_track_level_matches_reference():
    img0, img1, pts, guesses, valid = _lk_case(7)
    got = lk._track_level(t(img0), t(img1), t(pts), t(guesses), t(valid),
                          7, 8, 15, 0.01)
    for b in range(len(img0)):
        ref = jlk._track_level(jnp.asarray(img0[b]), jnp.asarray(img1[b]),
                               jnp.asarray(pts[b]), jnp.asarray(guesses[b]),
                               jnp.asarray(valid[b]), 7, 8, 15, 0.01)
        close(got[0][b], ref[0])
        np.testing.assert_array_equal(got[1][b].numpy(), np.asarray(ref[1]))


@pytest.mark.parametrize("seed,flow", [(8, (2.6, -1.7)), (9, (9.0, 6.5))])
def test_track_matches_reference(seed, flow):
    img0, img1, pts, guesses, valid = _lk_case(seed, flow=flow)
    pyr0 = image.build_pyramid(t(img0), 3)
    pyr1 = image.build_pyramid(t(img1), 3)
    got_xy, got_ok = lk.track(pyr0, pyr1, t(pts), t(guesses), t(valid),
                              win_size=15, iters=30, eps=0.01)
    assert int(got_ok.sum()) > 0
    for b in range(len(img0)):
        ref_xy, ref_ok = jlk.track(
            jimage.build_pyramid(jnp.asarray(img0[b]), 3),
            jimage.build_pyramid(jnp.asarray(img1[b]), 3),
            jnp.asarray(pts[b]), jnp.asarray(guesses[b]),
            jnp.asarray(valid[b]), win_size=15, iters=30, eps=0.01)
        close(got_xy[b], ref_xy)
        np.testing.assert_array_equal(got_ok[b].numpy(), np.asarray(ref_ok))


def test_cpu_tensors_launch_no_lk_kernel():
    img0, img1, pts, guesses, valid = _lk_case(10, B=1, N=8)
    n = (lk_ops.TEMPLATES.launches, lk_ops.GN.launches)
    lk.track(image.build_pyramid(t(img0), 2), image.build_pyramid(t(img1), 2),
             t(pts), t(guesses), t(valid))
    assert (lk_ops.TEMPLATES.launches, lk_ops.GN.launches) == n


# -- the cases of tests/test_frontend.py, run on the port (float32) --------

def _shift_image(img, dx, dy):
    """Bilinear shift: output(x) = img(x + d) (the reference's sampler)."""
    H, W = img.shape
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    return np.asarray(jimage.bilinear(
        jnp.asarray(img), jnp.stack([xs + dx, ys + dy], axis=-1))
    ).astype(np.float32)


@pytest.mark.parametrize("true_d,levels,n,min_ok,bound", [
    ((3.7, -2.2), 3, 16, 12, 0.3),       # test_lk_recovers_translation
    ((14.0, 9.0), 4, 12, 8, 0.5),        # test_lk_large_motion_via_pyramid
])
def test_lk_recovers_translation_on_the_port(true_d, levels, n, min_ok,
                                             bound):
    rng = np.random.default_rng(3)
    img0 = smooth_texture(rng).astype(np.float32)
    img1 = _shift_image(img0, *true_d)
    pyr0 = image.build_pyramid(t(img0)[None], levels)
    pyr1 = image.build_pyramid(t(img1)[None], levels)
    lo, hi = ((20, 20), (140, 100)) if levels == 3 else ((30, 30), (120, 90))
    pts = t(rng.uniform(lo, hi, size=(1, n, 2)).astype(np.float32))
    new_pts, ok = lk.track(pyr0, pyr1, pts, pts, torch.ones(1, n, dtype=bool),
                           win_size=15, iters=30)
    ok = ok[0].numpy()
    assert ok.sum() >= min_ok
    flow = (new_pts - pts)[0].numpy()
    err = np.linalg.norm(flow[ok] + np.asarray(true_d), axis=1)
    assert np.median(err) < bound, np.median(err)


def test_select_topk_masks_occupied_on_the_port():
    img = np.zeros((64, 64), np.float32)
    for (y, x) in [(16, 16), (16, 48), (48, 16), (48, 48)]:
        img[y - 3:y + 4, x - 3:x + 4] = 200.0
    score = fast.nms3(fast.fast_score(t(img)[None], 20.0))
    xy, sc, ok = fast.select_topk(score, 8, margin=4,
                                  occupied_xy=t([[[16.0, 16.0]]]),
                                  occupied_valid=t([[True]]), mask_size=15)
    xy = xy[0][ok[0]].numpy()
    assert not np.any((np.abs(xy[:, 0] - 16) <= 7)
                      & (np.abs(xy[:, 1] - 16) <= 7))
    assert len(xy) >= 3
