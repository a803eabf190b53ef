"""The port's hand-written CUDA kernels on the card.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA GPU
with ``nvcc`` and skips without one. The file imports no JAX, so it also
runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version (which the CPU
tests hold against the JAX package) on the same float32 inputs.
Cholesky kernels: tolerance 1e-4 absolute: well-conditioned inputs
(eigenvalues >= 0.1, entries O(1)), two float32 factorizations summing
in another order. LK kernels: on the inputs one pyramidal LK call on a
shifted texture gives them; the template windows within 1e-5 of each
track's largest entry (the same four taps, weights and order), the
Gauss-Newton loop's flags equal on at least 99.5 % of the live tracks
and its positions within 2 eps = 0.02 px on the tracks that converged in
both (the warp sums in another order, so a step within rounding of eps
may stop one iteration earlier or later), and within ``chip_smoke``'s
``GN_UNCONV_TOL`` (0.1 px) on the tracks that are unconverged in both.
"""
import numpy as np
import pytest
import torch

from chip_smoke import GN_UNCONV_TOL, Recorder, texture
from xivo_tpu_torch.frontend import lk as flk
from xivo_tpu_torch.frontend.image import build_pyramid
from xivo_tpu_torch.ops import lanes_chol as lc
from xivo_tpu_torch.ops import lk as lko

pytestmark = pytest.mark.cuda
TOL = 1e-4
EPS = 0.01


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def psd_batch(B, m, dead, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, m, m)) / np.sqrt(m)
    G = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(m)
    G[:, dead, :] = 0.0
    G[:, :, dead] = 0.0
    return torch.tensor(G, dtype=torch.float32, device="cuda")


def close(a, b, tol=TOL):
    torch.cuda.synchronize()
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=0,
                               atol=tol)


def zero_rows_stay_zero(X, dead):
    assert float(X[:, dead, :].abs().max()) == 0.0
    assert float(X[:, :, dead].abs().max()) == 0.0
    assert float(torch.triu(X, 1).abs().max()) == 0.0


@pytest.mark.parametrize("m", [12, 60, 228])
def test_chol_kernel_matches_plain_version(cuda, m):
    dead = [0, m // 3, m - 2]
    G = psd_batch(64, m, dead, seed=m)
    n = lc.CHOL.launches
    L = lc.chol_lanes(G)
    assert lc.CHOL.launches == n + 1
    close(L, lc.chol_plain(G))
    zero_rows_stay_zero(L, dead)


@pytest.mark.parametrize("m", [12, 60, 128])
def test_chol_inv_and_tri_inv_kernels_match_plain_versions(cuda, m):
    dead = [1, m // 2]
    G = psd_batch(64, m, dead, seed=m + 1)
    L, Linv = lc.chol_inv_lanes(G)
    Lp, Linvp = lc.chol_inv_plain(G)
    close(L, Lp)
    close(Linv, Linvp, 1e-3)   # the inverse amplifies by cond(L) <= ~10
    zero_rows_stay_zero(Linv, dead)
    # the downdate's (L + diag sqrt R): positive or dead diagonal
    Lr = (Lp + torch.diag_embed(
        (torch.diagonal(Lp, dim1=-2, dim2=-1) > 0).float())).contiguous()
    T = lc.tri_inv_lanes(Lr)
    close(T, lc.tri_inv_plain(Lr))
    zero_rows_stay_zero(T, dead)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    G = psd_batch(2, 8, [0], seed=0)
    with pytest.raises(TypeError):
        lc.chol_lanes(G.double())
    with pytest.raises(ValueError):
        lc.chol_lanes(G.transpose(1, 2))
    with pytest.raises(RuntimeError):  # two packed 300 x 300 > 227 KB
        lc.chol_inv_lanes(psd_batch(1, 300, [0], seed=0))


def lk_inputs(B=4, N=128, levels=4):
    """The inputs of every B4 and B5 launch of one pyramidal LK call on
    B textures moved by a few pixels, N tracks each, on the card."""
    H, W = 240, 320
    rng = np.random.default_rng(7)
    img0 = np.stack([texture(H, W, b) for b in range(B)])
    img1 = np.stack([texture(H, W, b, 3.3 + b, -2.6) for b in range(B)])
    pts = rng.uniform([20, 20], [W - 20, H - 20], size=(B, N, 2))
    valid = rng.uniform(size=(B, N)) < 0.9
    dev = torch.device("cuda")
    pyr0 = build_pyramid(torch.tensor(img0, device=dev), levels)
    pyr1 = build_pyramid(torch.tensor(img1, device=dev), levels)
    pts = torch.tensor(pts, dtype=torch.float32, device=dev)
    with Recorder(torch, lko, ["sample_templates", "gn_tracks"]) as seen:
        flk.track(pyr0, pyr1, pts, pts, torch.tensor(valid, device=dev),
                  win_size=15, iters=15, eps=EPS)
    torch.cuda.synchronize()
    assert len(seen["sample_templates"]) == len(seen["gn_tracks"]) == levels
    return seen


def test_lk_template_kernel_matches_plain_version(cuda):
    seen = lk_inputs()
    for tp, gxp, gyp, pos, w in seen["sample_templates"]:
        n = lko.TEMPLATES.launches
        got = lko.sample_templates(tp, gxp, gyp, pos, w)
        assert lko.TEMPLATES.launches == n + 1
        ref = lko.sample_templates_plain(tp, gxp, gyp, pos, w)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            assert g.shape == r.shape == tp.shape[:-2] + (w, w)
            scale = r.abs().amax(dim=(-2, -1)).clamp(min=1e-30)
            rel = (g - r).abs().amax(dim=(-2, -1)) / scale
            assert float(rel.max()) < 1e-5


def test_lk_gn_kernel_matches_plain_version(cuda):
    seen = lk_inputs()
    for sp, T, Gx, Gy, sc, pt, st, iters in seen["gn_tracks"]:
        n = lko.GN.launches
        pk, sk = lko.gn_tracks(sp, T, Gx, Gy, sc, pt, st, iters)
        assert lko.GN.launches == n + 1
        pp, sp_ = lko.gn_tracks_plain(sp, T, Gx, Gy, sc, pt, st, iters)
        torch.cuda.synchronize()
        live = st[..., 0] < 0.5
        same = (sk == sp_).all(dim=-1) & live
        assert float(same.sum()) >= 0.995 * float(live.sum())
        # positions of the tracks that converged in both; one still
        # unconverged after the budget moves by steps >= eps, so where it
        # stops depends on rounding: it is held to a looser limit
        conv = same & (sp_[..., 0] > 0.5) & (sp_[..., 1] < 0.5)
        unconv = same & (sp_[..., 0] < 0.5)
        dpos = (pk - pp).abs().amax(dim=-1)
        assert float(torch.where(conv, dpos, 0.0).max()) < 2 * EPS
        assert float(torch.where(unconv, dpos, 0.0).max()) < GN_UNCONV_TOL
        assert bool(((pk >= sc[..., 4:6]) & (pk <= sc[..., 6:8])).all())
        # tracks that start done come out exactly as they went in
        assert torch.equal(pk[~live], pt[~live])
        assert torch.equal(sk[~live], st[~live])


def test_lk_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    dev = torch.device("cuda")
    tp = torch.zeros((2, 31, 31), device=dev)
    pos = torch.zeros((2, 2), device=dev)
    with pytest.raises(TypeError):
        lko.sample_templates(tp.double(), tp.double(), tp.double(),
                             pos.double(), 15)
    with pytest.raises(ValueError):
        lko.sample_templates(tp.transpose(1, 2), tp, tp, pos, 15)
    T = torch.zeros((2, 15, 15), device=dev)
    sc = torch.zeros((2, 9), device=dev)
    with pytest.raises(TypeError):
        lko.gn_tracks(tp, T.double(), T, T, sc, pos, pos, 15)
    with pytest.raises(ValueError):
        lko.gn_tracks(tp, T, T.transpose(1, 2), T, sc, pos, pos, 15)

