"""The plain versions of the two LK kernels against the TPU kernel bodies.

``ops/lk.py``'s ``sample_templates_plain`` (B4) and ``gn_tracks_plain``
(B5) are what the hand-written CUDA kernels are held against on the card.
Here they are held against the Pallas kernels themselves,
``xivo_tpu/ops/lk_pallas.py::_tmpl_kernel`` and ``_gn_kernel``, run in
Pallas's interpret mode on the CPU (one grid step over all tracks, the
kernels' lanes layout built from the track-leading one). Nothing in the
JAX package changes for that.

Float32, on the inputs that one pyramidal LK call of the port gives the
kernels on textured frames moved by some 15 pixels (every level), far
enough that a few tracks escape their box or are still unconverged after
the budget. The template windows agree within 1e-5 of each track's
largest entry (the same taps and weights; the TPU kernel's 17-term
static-shift sum adds exact zeros). For the Gauss-Newton loop the flags
agree exactly and the positions within 1e-4 px on every track, converged
or not (the two sum the 225 window products in another order; the
largest difference read 3.8e-6 px).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from chip_smoke import Recorder, texture
from xivo_tpu.ops import lk_pallas
from xivo_tpu_torch.frontend import lk
from xivo_tpu_torch.frontend.image import build_pyramid
from xivo_tpu_torch.ops import lk as lk_ops

torch.set_num_threads(2)
S, W_, ITERS, EPS = 31, 15, 15, 0.01


@pytest.fixture(scope="module")
def captured():
    """The (B4, B5) inputs of every level of one LK call: B = 2
    sequences, N = 64 tracks each (128 tracks per launch), the second
    frame moved by (-12.4, 9.1) px."""
    rng = np.random.default_rng(0)
    H, W, B, N = 160, 200, 2, 64
    img0 = np.stack([texture(H, W, b) for b in range(B)])
    img1 = np.stack([texture(H, W, b, 12.4, -9.1) for b in range(B)])
    pts = rng.uniform([10.0, 10.0], [W - 10.0, H - 10.0], (B, N, 2))
    valid = rng.uniform(size=(B, N)) < 0.9
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)   # noqa: E731
    with Recorder(torch, lk_ops, ["sample_templates", "gn_tracks"]) as seen:
        lk.track(build_pyramid(f32(img0), 3), build_pyramid(f32(img1), 3),
                 f32(pts), f32(pts), torch.tensor(valid), win_size=W_,
                 iters=ITERS, eps=EPS)
    assert len(seen["sample_templates"]) == len(seen["gn_tracks"]) == 3
    return seen


def _lanes(x):
    """(B, N, ...) -> (..., B * N), the TPU kernels' layout."""
    x = x.reshape((-1,) + tuple(x.shape[2:])).numpy()
    return jnp.asarray(np.moveaxis(x, 0, -1))


def _spec(shape):
    """One block holding the whole array (grid of one step)."""
    return pl.BlockSpec(shape, lambda i: (0,) * len(shape))


def _call(kernel, args, out_shapes):
    return pl.pallas_call(
        kernel, grid=(1,),
        out_shape=tuple(jax.ShapeDtypeStruct(s, jnp.float32)
                        for s in out_shapes),
        in_specs=[_spec(a.shape) for a in args],
        out_specs=tuple(_spec(s) for s in out_shapes),
        interpret=True)(*args)


def test_template_plain_version_matches_tpu_kernel(captured):
    for tp, gxp, gyp, pos, w in captured["sample_templates"]:
        M = tp.shape[0] * tp.shape[1]
        ref = _call(functools.partial(lk_pallas._tmpl_kernel, S=S, w=w),
                    [_lanes(tp), _lanes(gxp), _lanes(gyp), _lanes(pos)],
                    [(w, w, M)] * 3)
        got = lk_ops.sample_templates_plain(tp, gxp, gyp, pos, w)
        for g, r in zip(got, ref):
            r = np.moveaxis(np.asarray(r), -1, 0).reshape(g.shape)
            g = g.numpy()
            scale = np.abs(r).max(axis=(-2, -1))
            assert scale.min() > 0
            rel = np.abs(g - r).max(axis=(-2, -1)) / scale
            assert rel.max() < 1e-5, rel.max()


def test_gn_plain_version_matches_tpu_kernel(captured):
    converged_total = unconverged_total = 0
    for sp, T, Gx, Gy, sc, pt, st, iters in captured["gn_tracks"]:
        lead = pt.shape[:-1]
        M = lead[0] * lead[1]
        rp, rs = _call(
            functools.partial(lk_pallas._gn_kernel, S=S, w=W_, iters=iters),
            [_lanes(x) for x in (sp, T, Gx, Gy, sc, pt, st)],
            [(2, M), (2, M)])
        rp = np.asarray(rp).T.reshape(lead + (2,))
        rs = np.asarray(rs).T.reshape(lead + (2,))
        gp, gs = (x.numpy() for x in lk_ops.gn_tracks_plain(
            sp, T, Gx, Gy, sc, pt, st, iters))
        np.testing.assert_array_equal(gs, rs)
        converged_total += int(((gs[..., 0] > 0.5) & (gs[..., 1] < 0.5)).sum())
        unconverged_total += int((gs[..., 0] < 0.5).sum())
        np.testing.assert_allclose(gp, rp, rtol=0, atol=1e-4)
        lo, hi = sc[..., 4:6].numpy(), sc[..., 6:8].numpy()
        assert ((gp >= lo) & (gp <= hi)).all()
        # tracks that start done leave as they came
        done0 = st[..., 0].numpy() > 0.5
        np.testing.assert_array_equal(gp[done0], pt.numpy()[done0])
    assert converged_total > 200 and unconverged_total > 0
