"""The port's hand-written CUDA kernels on the card.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA GPU
with ``nvcc`` and skips without one. The file imports no JAX, so it also
runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version (which the CPU
tests hold against the JAX package) on the same float32 inputs.
Cholesky kernels: tolerance 1e-4 absolute: well-conditioned inputs
(eigenvalues >= 0.1, entries O(1)), two float32 factorizations summing
in another order; the blocked Cholesky (whatever ``block`` the
reference's signature passes: the kernel has one panel width) against its
plain version, under both of its names (``chol_lanes``, B1,
and ``cholesky_batched``, B7: one kernel, each name counted on its own
counter) at the filter's widths (228, 229, 60, the tiny Dims' 96) and
batches of 1, 2 and 256; ``sqrt_form.factor_from_cov`` at (256, 228,
228) as one launch of B7 against its CPU plain run; B1 at 229 on a
rank-deficient bordered Gram (OOS measurement compression), held by its
backward error within
``chip_smoke``'s ``BACKWARD_TOL`` (see there why not row by row). A short run of the recommended accuracy config
at full width under the sync debug mode, with its launches a frame. The
reference's default filter (reference propagation, full covariance) at
full width on the card against the CPU, and its frame loop under the sync
debug mode with no propagation interval left unfinished by the substep
cap.
LK kernels: on the inputs one pyramidal LK call on a shifted texture
gives them; the template windows within 1e-5 of each
track's largest entry (the same four taps, weights and order), the
Gauss-Newton loop's flags equal on at least 99.5 % of the live tracks
and its positions within 2 eps = 0.02 px on the tracks that converged in
both (the warp sums in another order, so a step within rounding of eps
may stop one iteration earlier or later), and within ``chip_smoke``'s
``GN_UNCONV_TOL`` (0.1 px) on the tracks that are unconverged in both,
one launch a call and the tracks that start done returned as they came:
on the call's levels, on 1, 3, 5 and 513 tracks from track 1 of a table
(patch bases off 16-byte boundaries, a partial last block) with 0, 1
and 15 iterations, with every track done, and from the box's corners.
Hamming kernel: exactly equal distances and indices (integer work), with
ties, invalid entries, an all-invalid sequence and a sparse map (as a
live map is: a few hundred valid entries of 20000), without a query-row
mask and with one (random, all rows masked, only the planted copies
unmasked), masked rows at (10000, 0); one call is one CUDA kernel (the
profiler's count); and a short mapped run at full width under the sync
debug mode, with three launches a frame.
The fusion of ``retire_features`` on the card against the CPU, from the
same state and map: tables equal, positions (m) and covariances (of
their largest entry) within ``chip_smoke``'s ``MAP_FUSE_TOL32`` in
float32 and ``MAP_FUSE_TOL64`` in float64 (see there why they differ).
Fast propagation's IMU chain (``ops/imu_chain``, one launch a frame):
against its plain version in float32 and float64 on 1 to 11 slots, 4 and
5 grid substeps, padded slots mid-row and at the end, rows with dt_eff =
0, non-identity Cg, Ca and Rsg, B from 1 to 4096, each output within
``chip_smoke``'s ``CHAIN_TOL`` (float32 1e-5: the kernel sums in another
order over ~50 substeps, and the plain float32 version's own error
against float64 is ~1e-6 there; float64 1e-12), the interval counts
equal; the wrapper's refusals; one launch a PCW frame step with no host
sync, a ``use_oc`` run on the card against the CPU, and no launch on the
capped loop (``fast_substeps = 0``), batched propagation or the default
filter.
The homography RANSAC on the card against the CPU (masks and ``ok``
equal, no host sync), and the distorted camera models in float32 on the
card against the CPU.
The pyxivo ``Estimator`` built for the card against one built for the
CPU on ``tests/test_api.py::run_short``'s first frames (the square-root
form at full width, float32): positions within ``chip_smoke``'s
``API_PATH_TOL``, equal counts, B1-B3 once a frame.
The MATCH tracker (ORB detector and descriptor) at full width on the
card against the CPU for 3 frames, as ``chip_smoke``'s phase 32 holds it
(poses within ``IMG_PATH_TOL``, counts and spawned tracks equal), and
the ORB and BRISK words at a tiled image's oFAST picks on the card against
the CPU: at most ``DESC_BIT_SHARE`` of the bits differ (the orientation
sums run in another order on the card, so a bit whose two samples lie
within rounding may flip).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from chip_smoke import (CHAIN_TOL, DESC_BIT_SHARE, GN_UNCONV_TOL,
                        MAP_FUSE_TOL32, MAP_FUSE_TOL64, Recorder,
                        backward_use, chain_config, chain_errors,
                        compare_api_frames, compare_retire, drive_api,
                        imu_chain_inputs, make_mapped_run, make_run,
                        mapped_config, mapped_stream, random_hamming_inputs,
                        texture)
from xivo_tpu_torch.frontend import lk as flk
from xivo_tpu_torch.frontend.image import build_pyramid
from xivo_tpu_torch.ops import chol
from xivo_tpu_torch.ops import hamming as hm
from xivo_tpu_torch.ops import imu_chain as ic
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


@pytest.mark.parametrize("B", [1, 2, 256])
@pytest.mark.parametrize("m", [96, 60, 228, 229])
def test_one_kernel_serves_b1_and_b7(cuda, m, B):
    """chol_lanes (B1) and cholesky_batched (B7) launch the one blocked
    kernel at its default panel: the same L bit for bit, each launch
    counted on its own name only."""
    dead = [0, m // 3, m - 2]
    G = psd_batch(B, m, dead, seed=m + B)
    n1, n7 = lc.CHOL.launches, chol.CHOL_BLOCKED.launches
    L = lc.chol_lanes(G)
    assert (lc.CHOL.launches, chol.CHOL_BLOCKED.launches) == (n1 + 1, n7)
    L7 = chol.cholesky_batched(G)
    assert (lc.CHOL.launches, chol.CHOL_BLOCKED.launches) == (n1 + 1, n7 + 1)
    close(L, lc.chol_plain(G))
    zero_rows_stay_zero(L, dead)
    torch.cuda.synchronize()
    assert torch.equal(L, L7)


def test_chol_lanes_on_a_rank_deficient_bordered_gram(cuda):
    """OOS measurement compression's input at 229: the bordered Gram
    [[H^T H, H^T inn], [., |inn|^2]] of a rank-27 stack with a 1e-6
    relative jitter, exactly-zero columns of H for empty slots. Rows past
    the rank are set by the jitter, where two correct float32
    factorizations part by ~1e-2, so L is held by its backward error."""
    rng = np.random.default_rng(229)
    B, rows, rank, D = 64, 54, 27, 228
    H = rng.standard_normal((B, rows, rank)) @ rng.standard_normal(
        (B, rank, D))
    empty = [5, 100, 200, 227]
    H[:, :, empty] = 0.0
    Mb = np.concatenate([H, rng.standard_normal((B, rows, 1))], axis=-1)
    Gb = Mb.transpose(0, 2, 1) @ Mb
    Gb += np.einsum("bii,ij->bij", Gb, 1e-6 * np.eye(D + 1))
    G = torch.tensor(Gb, dtype=torch.float32, device="cuda")
    use, own = backward_use(torch, lc.chol_lanes, lc.chol_plain, [G])
    assert use <= 1.0, (use, own)
    zero_rows_stay_zero(lc.chol_lanes(G), empty)


@pytest.mark.parametrize("m", [12, 16, 17, 60, 120, 128])
def test_chol_inv_and_tri_inv_kernels_match_plain_versions(cuda, m):
    """B2 and B3 (``csrc/chol_blocked.cu``: B1's factorization, then the
    blocked inversion stage) at the panel and doubling edges: L is B1's
    and B7's bit for bit, and both still match the plain version; B3 with
    junk in the dead rows and columns below the diagonal, which it
    ignores as the plain version does."""
    dead = sorted({1, m // 2, min(15, m - 1)})
    G = psd_batch(64, m, dead, seed=m + 1)
    n2, n3 = lc.CHOL_INV.launches, lc.TRI_INV.launches
    L, Linv = lc.chol_inv_lanes(G)
    assert lc.CHOL_INV.launches == n2 + 1
    Lp, Linvp = lc.chol_inv_plain(G)
    close(L, Lp)
    close(Linv, Linvp, 1e-3)   # the inverse amplifies by cond(L) <= ~10
    zero_rows_stay_zero(L, dead)
    zero_rows_stay_zero(Linv, dead)
    L1, L7 = lc.chol_lanes(G), chol.cholesky_batched(G)
    close(L1, Lp)
    torch.cuda.synchronize()
    assert torch.equal(L, L1) and torch.equal(L, L7)
    # the downdate's (L + diag sqrt R): positive or dead diagonal
    Lr = (Lp + torch.diag_embed(
        (torch.diagonal(Lp, dim1=-2, dim2=-1) > 0).float())).contiguous()
    T = lc.tri_inv_lanes(Lr)
    assert lc.TRI_INV.launches == n3 + 1
    close(T, lc.tri_inv_plain(Lr))
    zero_rows_stay_zero(T, dead)
    junk = Lr.clone()
    rng = np.random.default_rng(m)
    for d in dead:
        junk[:, d, :d] = torch.tensor(rng.standard_normal((64, d)),
                                      dtype=torch.float32, device="cuda")
        junk[:, d + 1:, d] = torch.tensor(
            rng.standard_normal((64, m - d - 1)), dtype=torch.float32,
            device="cuda")
    junk += torch.triu(torch.ones_like(junk), 1)
    Tj = lc.tri_inv_lanes(junk)
    close(Tj, lc.tri_inv_plain(junk))
    close(Tj, T, 0.0)
    zero_rows_stay_zero(Tj, dead)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    G = psd_batch(2, 8, [0], seed=0)
    with pytest.raises(TypeError):
        lc.chol_lanes(G.double())
    with pytest.raises(ValueError):
        lc.chol_lanes(G.transpose(1, 2))
    # B2 and B3 keep L packed by columns and L^-1 packed by rows: 374 KB
    # at 300 rows, > 227 KB
    with pytest.raises(RuntimeError):
        lc.chol_inv_lanes(psd_batch(1, 300, [0], seed=0))
    with pytest.raises(RuntimeError):
        lc.tri_inv_lanes(psd_batch(1, 300, [0], seed=0))
    with pytest.raises(RuntimeError):  # a packed 400 x 400 > 227 KB
        lc.chol_lanes(psd_batch(1, 400, [0], seed=0))


@pytest.mark.parametrize("m,block", [(12, 32), (60, 32), (228, 32),
                                     (60, 8), (228, 16), (229, 32)])
def test_chol_blocked_kernel_matches_plain_version_and_b1(cuda, m, block):
    dead = [0, m // 3, m - 2]
    G = psd_batch(64, m, dead, seed=m + block)
    n = chol.CHOL_BLOCKED.launches
    L = chol.cholesky_batched(G, block=block)
    assert chol.CHOL_BLOCKED.launches == n + 1
    close(L, chol.cholesky_plain(G))
    close(L, lc.chol_lanes(G))              # B1 keeps the same contract
    zero_rows_stay_zero(L, dead)
    # one panel width: the reference's `block` changes nothing
    assert torch.equal(L, chol.cholesky_batched(G))


def test_cholesky_psd_sends_any_batch_to_one_launch(cuda):
    G = psd_batch(6, 60, [5], seed=2)
    for X in (G[0], G.reshape(2, 3, 60, 60)):
        n = chol.CHOL_BLOCKED.launches
        L = chol.cholesky_psd(X)
        assert chol.CHOL_BLOCKED.launches == n + 1
        assert L.shape == X.shape
        close(L, chol.cholesky_plain(X))


def test_factor_from_cov_is_one_b7_launch(cuda):
    """``sqrt_form.factor_from_cov`` at full width: one launch of B7,
    within TOL of its CPU plain run, dead rows and the slack exactly 0."""
    from xivo_tpu_torch.filter.layout import Dims
    from xivo_tpu_torch.filter.sqrt_form import factor_from_cov
    dims = Dims()
    D, dead = dims.full, [0, 40, 227]
    assert D == 228
    P = psd_batch(256, D, dead, seed=16)
    n = chol.CHOL_BLOCKED.launches
    S = factor_from_cov(P, dims)
    assert chol.CHOL_BLOCKED.launches == n + 1
    assert S.shape == (256, D, D + 3 * dims.n_features)
    close(S, factor_from_cov(P.cpu(), dims))
    zero_rows_stay_zero(S[..., :D], dead)
    assert float(S[..., D:].abs().max()) == 0.0


def test_chol_blocked_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    G = psd_batch(2, 8, [0], seed=0)
    with pytest.raises(TypeError):
        chol.cholesky_batched(G.double())
    with pytest.raises(ValueError):     # an empty batch launches nothing
        chol.cholesky_batched(G[:0])
    with pytest.raises(ValueError):
        chol.cholesky_batched(G.transpose(1, 2))
    with pytest.raises(RuntimeError):  # a packed 400 x 400 > 227 KB
        chol.cholesky_batched(psd_batch(1, 400, [0], seed=0))


def test_chol_lanes_at_the_compression_width(cuda):
    """B1 at (D + 1)^2 = 229^2, OOS measurement compression's shape:
    106,256 bytes of shared memory and 1024 threads a matrix."""
    dead = [3, 100, 228]
    G = psd_batch(32, 229, dead, seed=229)
    L = lc.chol_lanes(G)
    close(L, lc.chol_plain(G))
    zero_rows_stay_zero(L, dead)


@pytest.mark.parametrize("ratio,b1", [(1.5, 1), (0.5, 2)])
def test_accuracy_run_never_waits_for_the_card(cuda, ratio, b1):
    """The recommended accuracy config at default Dims (D = 228): B1 once
    a frame (twice with compression forced), B2 and B3 three times (the
    60-row instate update and the two 120-row blocks of the 240-row OOS
    stack, or of the 228 compressed rows)."""
    from xivo_tpu_torch.runner import run_batch
    from xivo_tpu_torch.sim.configs import accuracy_config
    cfg = accuracy_config(compression_trigger_ratio=ratio)
    T = 6
    s, fib, _ = make_run(cfg, torch, "cuda", 2, frames=T)
    run_batch(cfg, s, fib)                   # makes the device constants
    torch.cuda.synchronize()
    before = {k.name: k.launches for k in lc.KERNELS}
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, out = run_batch(cfg, s, fib)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    got = {k.name: k.launches - before[k.name] for k in lc.KERNELS}
    assert got == {"chol_lanes": b1 * T, "chol_inv_lanes": 3 * T,
                   "tri_inv_lanes": 3 * T}
    assert bool(torch.isfinite(out.Tsb).all())


def test_traced_frame_steps_never_wait_for_the_card(cuda):
    """With ``tracing`` on, the PCW frame step at default Dims still makes
    no host sync (its spans read the host's clock and the allocator's
    counters alone), and every frame span carries the allocator's
    counts."""
    from chip_smoke import pcw_config
    from xivo_tpu_torch import tracing
    from xivo_tpu_torch.runner import run_batch
    cfg = pcw_config()
    T = 4
    s, fib, _ = make_run(cfg, torch, "cuda", 2, frames=T)
    run_batch(cfg, s, fib)                   # makes the device constants
    torch.cuda.synchronize()
    tracing.clear()
    tracing.enable()
    n = ic.CHAIN.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, out = run_batch(cfg, s, fib)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        tracing.disable()
    torch.cuda.synchronize()
    assert ic.CHAIN.launches == n + T       # the IMU chain: one a frame
    spans = tracing.records()
    tracing.clear()
    frames = [r for r in spans if r.name == tracing.FRAME]
    assert len(frames) == T
    assert all(set(f.info) == {"device_allocs", "alloc_retries"}
               for f in frames)
    assert {tracing.PROPAGATE, tracing.UPDATE, tracing.CHOL_LANES} \
        <= {r.name for r in spans}
    for f in frames:            # the launch under imu_slots, once a frame
        kids = [r.name for r in spans if r.frame == f.frame
                and r.name in (tracing.IMU_SLOTS, tracing.VISUAL_SEGMENT)]
        assert kids == [tracing.IMU_SLOTS]      # no use_oc: no correction
    assert bool(torch.isfinite(out.Tsb).all())


def test_oc_frame_steps_on_the_card_match_the_cpu(cuda):
    """``use_oc`` (the correction on the kernel's outputs) on the card
    against the same config on the CPU (the plain version): poses within
    phase 4's 1e-3 m over 6 frames, counts equal, one launch a frame."""
    from chip_smoke import COUNT_FIELDS, pcw_config
    from xivo_tpu_torch.runner import run_batch
    cfg = dataclasses.replace(pcw_config(), use_oc=True)
    T = 6
    outs = {}
    for dev in ("cuda", "cpu"):
        s, fib, _ = make_run(cfg, torch, dev, 2, frames=T)
        n = ic.CHAIN.launches
        outs[dev] = run_batch(cfg, s, fib)[1]
        assert ic.CHAIN.launches == n + (T if dev == "cuda" else 0)
    dpos = float((outs["cuda"].Tsb.cpu() - outs["cpu"].Tsb).abs().max())
    assert dpos < 1e-3, dpos
    for name in COUNT_FIELDS:
        assert torch.equal(getattr(outs["cuda"], name).cpu(),
                           getattr(outs["cpu"], name)), name


@pytest.mark.parametrize("over", [dict(fast_substeps=0),
                                  dict(propagation_mode="batched",
                                       covariance_form="full")])
def test_other_propagation_paths_launch_no_chain_kernel(cuda, over):
    """The capped loop (``fast_substeps = 0``) and batched propagation
    keep their own code on the card: no launch of the IMU chain."""
    from chip_smoke import pcw_config
    from xivo_tpu_torch.runner import run_batch
    cfg = dataclasses.replace(pcw_config(), **over)
    s, fib, _ = make_run(cfg, torch, "cuda", 2, frames=3)
    n = ic.CHAIN.launches
    _, out = run_batch(cfg, s, fib)
    torch.cuda.synchronize()
    assert ic.CHAIN.launches == n
    assert bool(torch.isfinite(out.Tsb).all())


def test_default_filter_on_the_card_matches_the_cpu(cuda):
    """``config_from_json(PCW_CFG)`` as it stands (reference Prince-Dormand
    propagation, full covariance) at full width: the card's run of B = 2
    against the CPU's, poses within ``chip_smoke``'s FULL_PATH_TOL, counts
    equal, no Cholesky kernel launched (the dense form solves with
    ``cholesky_ex``/``cholesky_solve``)."""
    from chip_smoke import COUNT_FIELDS, FULL_PATH_TOL, default_config
    from xivo_tpu_torch.runner import run_batch
    cfg = default_config()
    before = {k.name: k.launches
              for k in lc.KERNELS + chol.KERNELS + ic.KERNELS}
    outs = {}
    for dev in ("cuda", "cpu"):
        s, fib, _ = make_run(cfg, torch, dev, 2, frames=4)
        outs[dev] = run_batch(cfg, s, fib)[1]
    dpos = float((outs["cuda"].Tsb.cpu() - outs["cpu"].Tsb).abs().max())
    assert dpos < FULL_PATH_TOL, dpos
    for name in COUNT_FIELDS:
        assert torch.equal(getattr(outs["cuda"], name).cpu(),
                           getattr(outs["cpu"], name)), name
    assert {k.name: k.launches
            for k in lc.KERNELS + chol.KERNELS + ic.KERNELS} == before


def test_default_filter_run_never_waits_and_finishes_every_interval(cuda):
    """The default filter's frame loop under the sync debug mode, its
    substep counters read once after it: no interval left unfinished at
    the fitted cap; with a cap below it the runner raises."""
    import dataclasses
    from chip_smoke import default_config
    from xivo_tpu_torch.filter import propagate
    from xivo_tpu_torch.runner import run_batch
    cfg = default_config(sim_initialize_depths=True)
    s, fib, _ = make_run(cfg, torch, "cuda", 2, frames=6)
    run_batch(cfg, s, fib)                   # makes the device constants
    torch.cuda.synchronize()
    propagate.reset_substep_counts("cuda")
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, out = run_batch(cfg, s, fib, check=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    unfinished, most = propagate.substep_counts("cuda")
    assert int(unfinished) == 0 and 0 < int(most) <= cfg.max_substeps
    assert bool(torch.isfinite(out.Tsb).all())
    with pytest.raises(RuntimeError, match="left unfinished"):
        run_batch(dataclasses.replace(cfg, max_substeps=int(most) - 1), s,
                  fib)


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


def hold_gn(args):
    """One launch of B5 on args, held against the plain version; returns
    the kernel's (pt, st)."""
    sp, T, Gx, Gy, sc, pt, st, iters = args
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
    assert float(torch.where(unconv, dpos, 0.0).max()) \
        < GN_UNCONV_TOL
    assert bool(((pk >= sc[..., 4:6]) & (pk <= sc[..., 6:8])).all())
    # tracks that start done come out exactly as they went in
    assert torch.equal(pk[~live], pt[~live])
    assert torch.equal(sk[~live], st[~live])
    return pk, sk


def test_lk_gn_kernel_matches_plain_version(cuda):
    seen = lk_inputs()
    for args in seen["gn_tracks"]:
        hold_gn(args)


@functools.lru_cache(maxsize=None)
def gn_track_table(iters=15):
    """The B5 inputs of every level of lk_inputs() as one table of 2048
    tracks (leading dimension flattened), and the kernel's outputs for
    them, one launch a level, each held by hold_gn; on the card."""
    calls = lk_inputs()["gn_tracks"]
    outs = [hold_gn(c[:7] + (iters,)) for c in calls]

    def flat(xs):
        return torch.cat([x.reshape((-1,) + x.shape[2:]) for x in xs])
    return (tuple(flat([c[i] for c in calls]) for i in range(7)),
            tuple(flat([o[i] for o in outs]) for i in range(2)))


@pytest.mark.parametrize("iters", [0, 1, 15])
@pytest.mark.parametrize("M", [1, 3, 5, 4 * 128 + 1])
def test_lk_gn_kernel_at_any_track_count(cuda, M, iters):
    """M tracks from track 1 of the table: every patch base 4 bytes off a
    16-byte boundary at one track in four, a partial last block of four
    warps. Each track's result is the one it gets in its level's launch,
    bit for bit (a warp a track; the plain version on a table of another
    shape may sum in another order, which moves an unconverged track by
    more than GN_UNCONV_TOL); the flags agree with the plain version's
    and a track that starts done, or any track with no iterations, comes
    out as it went in."""
    table, (pk_all, sk_all) = gn_track_table(iters)
    sp, T, Gx, Gy, sc, pt, st = (x[1:1 + M] for x in table)
    assert all(x.is_contiguous() for x in (sp, T, Gx, Gy, sc, pt, st))
    n = lko.GN.launches
    pk, sk = lko.gn_tracks(sp, T, Gx, Gy, sc, pt, st, iters)
    assert lko.GN.launches == n + 1
    _, sk_plain = lko.gn_tracks_plain(sp, T, Gx, Gy, sc, pt, st, iters)
    torch.cuda.synchronize()
    assert torch.equal(pk, pk_all[1:1 + M])
    assert torch.equal(sk, sk_all[1:1 + M])
    live = st[:, 0] < 0.5
    same = (sk == sk_plain).all(dim=-1) & live
    assert float(same.sum()) >= 0.995 * float(live.sum())
    done = ~live if iters else torch.ones_like(live)
    assert torch.equal(pk[done], pt[done]) and torch.equal(sk[done], st[done])


def test_lk_gn_kernel_when_every_track_starts_done(cuda):
    sp, T, Gx, Gy, sc, pt, st = gn_track_table()[0]
    st = torch.stack([torch.ones_like(st[:, 0]), st[:, 1]], dim=-1)
    pk, sk = hold_gn((sp, T, Gx, Gy, sc, pt, st, 15))
    assert torch.equal(pk, pt) and torch.equal(sk, st)


def test_lk_gn_kernel_from_the_corners_of_the_box(cuda):
    """Iterates that start on each corner of their box (the patch's
    first or last searchable window on both axes)."""
    sp, T, Gx, Gy, sc, pt, st = gn_track_table()[0]
    lo, hi = sc[:, 4:6], sc[:, 6:8]
    corner = torch.arange(pt.shape[0], device=pt.device) % 4
    pt = torch.stack([torch.where(corner % 2 == 0, lo[:, 0], hi[:, 0]),
                      torch.where(corner < 2, lo[:, 1], hi[:, 1])], dim=-1)
    hold_gn((sp, T, Gx, Gy, sc, pt.contiguous(), st, 15))


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



def query_mask(kind, B, F, g):
    """A (B, F) query-row mask, or None: "random" keeps about a third of
    the rows, "planted" only the planted copies (rows :F // 2)."""
    if kind == "none":
        return None
    qm = torch.zeros((B, F), dtype=torch.bool, device="cuda")
    if kind == "random":
        qm = torch.rand((B, F), generator=g, device="cuda") < 0.3
    elif kind == "planted":
        qm[:, :F // 2] = True
    return qm


@pytest.mark.parametrize("qmask", ["none", "random", "all_false",
                                   "planted"])
@pytest.mark.parametrize("B,M,F,share", [
    (8, 20000, 256, 1.0), (8, 20000, 30, 1.0), (3, 20011, 300, 1.0),
    (8, 20000, 256, 0.005), (8, 20000, 30, 0.005), (2, 40000, 256, 0.5),
    (600, 20000, 300, 0.005)])
def test_hamming_kernel_matches_plain_version(cuda, B, M, F, share, qmask):
    """At B = 2, 3 and 8 the rows of a sequence are split over several
    clusters of 8 CTAs, and M = 40000 takes two rounds of the mask (a
    round is 8 x 4096 entries); B = 600 takes one cluster a sequence, so
    its 300 rows take two passes."""
    q, d, v = random_hamming_inputs(torch, B, M, F, seed=F + M)
    # keep a share of the entries valid, and the planted rows
    g = torch.Generator(device=d.device)
    g.manual_seed(M)
    keep = torch.rand(v.shape, generator=g, device=d.device) < share
    keep[:, 5000:5000 + F // 2] = True
    v = v & keep
    qm = query_mask(qmask, B, F, g)
    n = hm.HAMMING.launches
    gd, gi = hm.hamming_nn(q, d, v, qm)
    assert hm.HAMMING.launches == n + 1
    pd, pi = hm.hamming_nn_plain(q, d, v, qm)
    torch.cuda.synchronize()
    assert torch.equal(gd, pd) and torch.equal(gi, pi)
    on = torch.ones_like(gd, dtype=torch.bool) if qm is None else qm
    assert bool((gd[~on] == hm.NO_MATCH).all()) and \
        bool((gi[~on] == 0).all())
    # planted copies: distance 0 at the first of two equal map rows
    h = F // 2
    if qmask in ("none", "planted"):
        assert torch.equal(gi[0, :h], torch.arange(5000, 5000 + h,
                                                   device=gi.device))
        assert bool((gd[0, :h] == 0).all())
    assert bool((gd[1] == hm.NO_MATCH).all()) and bool((gi[1] == 0).all())


def test_one_hamming_call_is_one_kernel(cuda):
    """Nothing runs before or after the kernel: the profiler sees one
    CUDA kernel for one call, with the query-row mask and without."""
    from torch.profiler import ProfilerActivity, profile
    q, d, v = random_hamming_inputs(torch, 8, 20000, 256, seed=3)
    qm = torch.zeros((8, 256), dtype=torch.bool, device="cuda")
    qm[:, ::7] = True
    for mask in (None, qm):
        hm.hamming_nn(q, d, v, mask)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            hm.hamming_nn(q, d, v, mask)
            torch.cuda.synchronize()
        kernels = {e.key: e.count for e in prof.key_averages()
                   if "CUDA" in str(getattr(e, "device_type", ""))
                   and (getattr(e, "self_device_time_total", 0) or 0) > 0}
        assert sum(kernels.values()) == 1, kernels
        # one instance of the kernel template (its cluster size)
        assert any("::hamming_nn_kernel<" in k for k in kernels), kernels


def test_hamming_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, d, v = random_hamming_inputs(torch, 2, 20000, 30, seed=0)
    with pytest.raises(TypeError):
        hm.hamming_nn(q.int(), d, v)
    with pytest.raises(ValueError):
        hm.hamming_nn(q, d[:, :, :4], v)
    with pytest.raises(ValueError):
        hm.hamming_nn(q, d.transpose(0, 1).contiguous().transpose(0, 1), v)
    qm = torch.ones((2, 30), dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError):
        hm.hamming_nn(q, d, v, qm[:, :29])
    with pytest.raises(TypeError):
        hm.hamming_nn(q, d, v, qm.to(torch.uint8))
    with pytest.raises(ValueError):
        hm.hamming_nn(q, d, v, torch.ones((30, 2), dtype=torch.bool,
                                          device="cuda").t())
    wide = q[:, :1].expand(2, hm.MAX_QUERIES + 1, 8).contiguous()
    with pytest.raises(ValueError):
        hm.hamming_nn(wide, d, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("KI,S,B,dt", [(1, 4, 1, None), (5, 4, 4096, 0.01),
                                       (10, 4, 4096, 0.005),
                                       (5, 4, 4096, None), (10, 5, 37, None),
                                       (11, 5, 300, None), (11, 4, 2, None)])
def test_imu_chain_kernel_matches_plain_version(cuda, dtype, KI, S, B, dt):
    """One launch against the plain version on the same inputs: random
    slot lengths with padded slots and dt_eff = 0 rows, or every slot dt
    long as the benchmark's 100 and 200 Hz streams pack them."""
    args = imu_chain_inputs(torch, B, KI, dtype, seed=10 * KI + S, dt=dt)
    cfg = chain_config(S)
    n = ic.CHAIN.launches
    got = ic.imu_chain(cfg, *args)
    assert ic.CHAIN.launches == n + 1
    err = chain_errors(torch, got, ic.chain_plain(cfg, *args))
    assert max(err.values()) <= CHAIN_TOL[str(dtype).split(".")[-1]], err


def test_imu_chain_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    cfg = chain_config()
    X, lg, la, sg, sa, gy, ac, dt, dte = imu_chain_inputs(
        torch, 3, 4, torch.float32, seed=0)
    head = (X, lg, la, sg, sa)
    n = ic.CHAIN.launches
    with pytest.raises(TypeError):
        ic.imu_chain(cfg, type(X)(*(v.half() for v in X)),
                     *(v.half() for v in (lg, la, sg, sa, gy, ac, dt, dte)))
    with pytest.raises(TypeError):
        ic.imu_chain(cfg, *head, gy, ac, dt, dte.double())
    with pytest.raises(ValueError):     # slot lengths the readings lack
        ic.imu_chain(cfg, *head, gy, ac, torch.cat([dt, dt], 1), dte)
    with pytest.raises(ValueError):
        ic.imu_chain(cfg, X._replace(Cg=X.Cg[:, :2]), lg, la, sg, sa, gy,
                     ac, dt, dte)
    with pytest.raises(ValueError):
        ic.imu_chain(cfg, *head, gy, ac, dt, dte.cpu())
    with pytest.raises(ValueError):     # the capped loop is not the grid
        ic.imu_chain(dataclasses.replace(cfg, fast_substeps=0), *head, gy,
                     ac, dt, dte)
    with pytest.raises(ValueError):     # an empty batch launches nothing
        ic.imu_chain(cfg, type(X)(*(v[:0] for v in X)),
                     *(v[:0] for v in (lg, la, sg, sa, gy, ac, dt, dte)))
    assert ic.CHAIN.launches == n


def test_mapped_run_never_waits_for_the_card(cuda):
    from xivo_tpu_torch.runner import run_batch_mapped
    cfg = mapped_config()
    stream = mapped_stream(cfg)
    T = 6
    s, ms, fib, _ = make_mapped_run(cfg, torch, "cuda", 2, stream,
                                    frames=T, capacity=2048)
    run_batch_mapped(cfg, s, ms, fib)        # makes the device constants
    torch.cuda.synchronize()
    n = hm.HAMMING.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, ms2, out, lcs = run_batch_mapped(cfg, s, ms, fib, seed=3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert hm.HAMMING.launches == n + 3 * T
    assert bool(torch.isfinite(out.Tsb).all())


@pytest.mark.parametrize("dtype,tol", [(None, MAP_FUSE_TOL32),
                                       (torch.float64, MAP_FUSE_TOL64)])
def test_retire_fusion_on_the_card_matches_the_cpu(cuda, dtype, tol):
    from xivo_tpu_torch.runner import run_batch_mapped
    cfg = mapped_config()
    stream = mapped_stream(cfg)
    s, ms, fib, _ = make_mapped_run(cfg, torch, "cuda", 2, stream,
                                    frames=12, capacity=2048)
    s, ms, _, _ = run_batch_mapped(cfg, s, ms, fib)
    got, ref, same, dx, dcov = compare_retire(torch, cfg, s, ms, dtype)
    assert same
    assert int((ref.n_merged - ms.n_merged.cpu()).min()) > 0
    assert dx < tol and dcov < tol, (dx, dcov)


def test_homography_on_the_card_matches_the_cpu(cuda):
    """``homography_ransac`` (float32, B = 16 scenes of 256 rows with 0.5 px
    noise, 15 % outliers moved 20-60 px, a quarter of the rows invalid)
    gives the CPU's masks and ``ok`` on the same draws, with no host sync:
    no residual lies near the 3 px threshold."""
    from xivo_tpu_torch.frontend.homography import N_HYPS, homography_ransac
    rng = np.random.default_rng(2)
    B, N = 16, 256
    p0 = rng.uniform(0, 512, (B, N, 2))
    p1 = p0 * 1.01 + np.array([3.0, -2.0]) + rng.normal(0, 0.5, (B, N, 2))
    out = rng.random((B, N)) < 0.15
    ang = rng.uniform(0, 2 * np.pi, (B, N))
    p1 += (out * rng.uniform(20, 60, (B, N)))[..., None] * np.stack(
        [np.cos(ang), np.sin(ang)], -1)
    valid = rng.random((B, N)) >= 0.25
    u = rng.random((B, N_HYPS, N))
    args = [torch.tensor(a, dtype=torch.float32) for a in (u, p0, p1)]
    want = homography_ransac(*args[:3], torch.tensor(valid))
    on_card = [a.to(cuda) for a in args] + [torch.tensor(valid, device=cuda)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = homography_ransac(*on_card)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert bool(want[1].all())


@pytest.mark.parametrize("model", ["atan", "equidistant", "radtan"])
def test_camera_models_on_the_card_match_the_cpu(cuda, model):
    """``project_with_jac`` and ``unproject`` in float32 on the card
    against the CPU: the same closed forms, rounded on another device."""
    from xivo_tpu_torch.cam import models as cam
    cfg = {"atan": dict(w=0.936), "equidistant": dict(
        k0=0.0034, k1=0.0007, k2=-0.0046, k3=0.0014), "radtan": dict(
        p1=0.0007, p2=-0.0008, k1=-0.28, k2=0.07, k3=-0.005)}[model]
    kind, intrin, _ = cam.intrinsics_from_cfg(dict(
        model=model, rows=480, cols=640, fx=275.0, fy=274.0, cx=319.5,
        cy=239.5, **cfg), dtype=torch.float32)
    xc = torch.tensor(np.random.default_rng(4).uniform(-0.5, 0.5, (512, 2)),
                      dtype=torch.float32)
    for fn, tol in ((lambda i, x: cam.project_with_jac(kind, i, x), 2e-3),
                    (lambda i, x: (cam.unproject(kind, i, cam.project(
                        kind, i, x)),), 1e-5)):
        for g, w in zip(fn(intrin.to(cuda), xc.to(cuda)), fn(intrin, xc)):
            np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=0,
                                       atol=tol)


def test_estimator_on_the_card_matches_the_cpu(cuda):
    from xivo_tpu_torch.api import Estimator
    from xivo_tpu_torch.filter.config import config_from_json
    from xivo_tpu_torch.sim.configs import PCW_CFG
    from xivo_tpu_torch.sim.stream import run_short_messages
    cfg = config_from_json(PCW_CFG, sim_initialize_depths=True,
                           propagation_mode="fast", covariance_form="sqrt")
    est = Estimator(cfg)
    assert est.device.type == "cuda"
    msgs = run_short_messages(*est.gbc(), T=0.5)
    for k in lc.KERNELS:
        k.launches = 0
    got, _ = drive_api(torch, est, msgs)
    assert [k.launches for k in lc.KERNELS] == [len(got)] * 3
    want, _ = drive_api(torch, Estimator(cfg, device="cpu"), msgs)
    compare_api_frames("estimator", got, want)
    assert len(got) == 10 and got[-1][1][0] > 0


def test_match_tracker_on_the_card_matches_the_cpu(cuda):
    from chip_smoke import compare_front_end, image_config
    from xivo_tpu_torch.sim.image_stream import VIS_DT, build_image_stream
    cfg = image_config(tracker_type="MATCH", detector="ORB",
                           descriptor="orb")
    stream = build_image_stream(cfg, total_time=VIS_DT * 3 + 0.01)
    assert stream[0].image.shape[0] == 3
    compare_front_end(torch, "match", cfg, stream, 3)


@pytest.mark.parametrize("kind", ["orb", "brisk"])
def test_steered_words_on_the_card_match_the_cpu(cuda, kind):
    from xivo_tpu_torch.frontend import brief, descriptors, fast
    from xivo_tpu_torch.frontend.image import blur5
    # random 8 x 8 px tiles: corners everywhere
    rng = np.random.default_rng(6)
    img = torch.tensor(np.kron(rng.uniform(0, 255, (2, 32, 40)),
                               np.ones((8, 8))), dtype=torch.float32)
    xy, _, ok = fast.select_topk(
        fast.nms3(fast.ofast_score(img, 15.0)), 128, 8,
        torch.zeros((2, 1, 2)), torch.zeros((2, 1), dtype=torch.bool), 15)
    assert int(ok.sum()) > 100
    k = descriptors.KINDS[kind]
    want = descriptors.extract(k, blur5(img), xy)
    got = descriptors.extract(k, blur5(img.to(cuda)), xy.to(cuda)).cpu()
    flips = int(brief.popcount32(torch.bitwise_xor(got, want)).sum(-1)[ok]
                .sum())
    assert flips <= DESC_BIT_SHARE * int(ok.sum()) * brief.N_BITS, flips
