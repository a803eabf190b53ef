"""Smoke test of the PyTorch/CUDA port (``xivo_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. print the card's name and power limit; check that TF32 is off;
2. build every CUDA source of ``xivo_tpu_torch/csrc`` (one nvcc process
   per source, all started together, sm_90a);
PCW path (slice 1):
3. drive a few frames of the PCW main path at full width and keep the
   inputs its Cholesky kernels (B1-B3) saw; hold each kernel against its
   plain PyTorch version on those real matrices and on random PSD
   matrices with planted zero rows, and time kernel, plain version and
   the library call (``cholesky_ex``, ``solve_triangular``; on the same
   input with its dead rows made unit);
4. check the CUDA path against the port's CPU path (plain versions) at
   full width on a small batch (B = 2, 10 frames);
5. run the PCW main path: float32, default Dims (D = 228), B = 256
   sequences of the 5 s stream (T = 100 frames), every launch counter set
   to 0 just before and PyTorch's sync debug mode set to raise on any host
   sync in the frame loop; require finite poses, ATE-RMSE of sequence 0
   below 0.10 m and one launch of each Cholesky kernel per frame;
image path (slice 2):
6. drive a few frames of the image main path at full width (B = 16,
   512 x 512, 128-row track table) and keep the inputs the LK kernels (B4
   template windows, B5 Gauss-Newton loop) saw at every pyramid level;
   hold each against its plain version on those inputs and on the inputs
   of an LK call on random textures (B4 also on random patches), and
   time kernel, plain version and, for B4, ``grid_sample``;
7. check the CUDA image path against the port's CPU image path at full
   width (B = 2): 10 frames of the bench config and 20 with the default
   admission gate (features in the state from frame ~3 on); poses within
   1e-3 m, equal track and in-state feature counts;
8. run the image main path: B = 16 sequences of the 120-frame 512 x 512
   stream from fresh states, counters at 0 and the sync debug mode on;
   require finite poses, the reference's accuracy bounds on sequence 0
   (``tests/test_image_vio.py``: final error below 5 m, median below 3 m,
   at least 20 tracks from frame 10 on), 4 launches of B4 and B5 per
   frame and one of B1-B3;
9. where the time goes, for both main paths: ``torch.profiler`` over ten
   frame steps (frames 30-39) gives the device's busy share and its time
   by kernel, and the same frames run once more with a synchronize
   around each stage of the frame step give each stage's time (the image
   tracker's stages, from ``build_pyramid`` to BRIEF's ``extract``, are
   inside ``tracker_image``).

The last lines are the kernels' JSON line, the card line, and
``{"ok": true, "device": {...}}``. Without CUDA it prints no result and
exits 1.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

B = 256
TOTAL_TIME = 5.0        # bench.py's stage_pcw stream: T = 100 frames
CAPTURE_FRAMES = 12
ATE_BOUND = 0.10        # tests/test_e2e_pcw.py's bound
HBM_BYTES_S = 3.35e12   # H100 SXM device memory rate
F32_FLOPS = 67e12       # H100 SXM float32 peak outside the tensor cores
# kernel vs plain version, per row: the row's largest |difference| over
# its largest |entry| in the plain version, so that rows of small entries
# (biases, small-std states) are held as tightly as large ones. Two
# float32 factorizations may fairly differ by as much as either differs
# from float64, and that depends on the input: the innovation matrices of
# later frames give the plain version's L^-1 a row error of 1.1e-4 against
# float64, the random inputs 5e-7. So the limit on each input is
# ROW_TOL + ROW_TOL_SCALE x the plain float32 version's own row error
# there, and never above ROW_TOL_CAP.
ROW_TOL, ROW_TOL_SCALE, ROW_TOL_CAP = 1e-5, 4.0, 1e-3

IMG_B = 16              # bench.py's IMG_BATCH default
IMG_CAPTURE_FRAMES = 3
# tests/test_image_vio.py:79,90-91: tracks from frame 10 on, final and
# median position error
IMG_MIN_TRACKED, IMG_FINAL_BOUND, IMG_MEDIAN_BOUND = 20, 5.0, 3.0
# B4: the same four taps, weights and order as the plain version; per
# track, the largest |difference| over the largest |entry|
TMPL_TOL = 1e-5
# B5: the warp sums the 225 window products in another order than the
# plain version, so a step within rounding of eps may stop a track one
# iteration earlier or later: the flags agree on at least this share of
# the live tracks, and a track that converged in both ends within 2 eps.
# A track still unconverged after the budget keeps moving by steps of at
# least eps, so where it stops depends on rounding. On the H100 the
# largest such difference read 0.034 px (1294 tracks unconverged in both
# of 15,100 live ones, on the inputs below); the limit is 10 eps, about
# 3 x that reading. These tracks are not escaped, so their positions go
# on to the filter.
GN_FLAG_SHARE = 0.995
GN_UNCONV_TOL = 0.1
IMG_PATH_TOL = 1e-3     # CUDA vs CPU image path, m
IMG_CMP_FRAMES, IMG_CMP_OPEN_FRAMES = 10, 20
PROFILE_FRAMES = (30, 40)   # the window that phase 9 profiles

DEV = "cuda"            # the card every phase runs on
# the kernels of csrc/*.cu, as the profiler names them
OWN_KERNELS = ("chol_kernel", "chol_inv_kernel", "tri_inv_kernel",
               "templates_kernel", "gn_kernel")
REPLACES = {"chol_lanes": "xivo_tpu/ops/lanes_chol.py:103",
            "chol_inv_lanes": "xivo_tpu/ops/lanes_chol.py:108",
            "tri_inv_lanes": "xivo_tpu/ops/lanes_chol.py:133",
            "lk_sample_templates": "xivo_tpu/ops/lk_pallas.py:107",
            "lk_gn_tracks": "xivo_tpu/ops/lk_pallas.py:60"}


def build_kernels():
    """Build every CUDA source of the package at once, one nvcc process
    per source; returns {source: library path}."""
    from concurrent.futures import ThreadPoolExecutor
    from xivo_tpu_torch.ops import _build
    names = sorted(f[:-3] for f in os.listdir(_build.CSRC)
                   if f.endswith(".cu"))
    with ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(_build.build, names)))


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def make_run(cfg, torch, device, batch, frames=None):
    """(states, inputs, gt) for `batch` copies of the PCW bench stream."""
    from xivo_tpu_torch.runner import inputs_to_device
    from xivo_tpu_torch.sim.stream import build_pcw_stream
    fi, gt = build_pcw_stream(cfg, total_time=TOTAL_TIME, noise_px=0.25)
    if frames is not None:
        fi = type(fi)(*(a[:frames] for a in fi))
    fib = inputs_to_device(type(fi)(*(
        np.broadcast_to(a, (batch,) + a.shape) for a in fi)), device)
    return seeded_states(cfg, torch, device, batch, gt), fib, gt


def seeded_states(cfg, torch, device, batch, gt):
    """`batch` fresh filter states with the stream's first IMU reading."""
    from xivo_tpu_torch.runner import batch_states
    s = batch_states(cfg, batch, device)
    dt = s.P.dtype
    return s._replace(
        last_gyro=torch.tensor(gt["gyro0"], dtype=dt,
                               device=device).expand(batch, 3).clone(),
        last_accel=torch.tensor(gt["accel0"], dtype=dt,
                                device=device).expand(batch, 3).clone())


def make_image_run(cfg, torch, device, batch, stream, frames=None):
    """(states, front-end states, inputs) for `batch` sequences of the
    image stream, the images on the device once, broadcast to the batch."""
    from xivo_tpu_torch.runner import (batch_frontend_states,
                                       image_inputs_to_device)
    fi, gt = stream
    if frames is not None:
        fi = type(fi)(*(a[:frames] for a in fi))
    return (seeded_states(cfg, torch, device, batch, gt),
            batch_frontend_states(cfg, batch, device),
            image_inputs_to_device(fi, device, batch=batch))


def cuda_ms(torch, fn, reps=20):
    """Mean device time of fn() over reps calls, after a warm-up. A call's
    host side (Python, argument checks, the launch) can take longer than
    a small kernel, so the card is held by a sleep kernel while the host
    enqueues all reps, and the events then time the device alone."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # at most 2 GHz: the sleep lasts at least 2 x the host's enqueue time
    torch.cuda._sleep(int(2e9 * (2 * host_s + 0.005)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Recorder:
    """Replace module functions by wrappers that keep a copy of their
    tensor arguments, while the `with` block runs. The LK kernels' tests
    use it too."""

    def __init__(self, torch, module, names):
        self.torch, self.module, self.names = torch, module, names
        self.seen = {n: [] for n in names}

    def __enter__(self):
        self.orig = {n: getattr(self.module, n) for n in self.names}
        for n in self.names:
            setattr(self.module, n, self._wrap(n))
        return self.seen

    def _wrap(self, name):
        def fn(*args):
            self.seen[name].append(tuple(
                a.detach().clone() if self.torch.is_tensor(a) else a
                for a in args))
            return self.orig[name](*args)
        return fn

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.module, n, fn)


def random_psd(torch, batch, m, seed):
    """Well-conditioned PSD (B, m, m) float32 with planted zero rows/cols."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((batch, m, m)) / np.sqrt(m)
    G = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(m)
    dead = rng.choice(m, size=max(1, m // 10), replace=False)
    G[:, dead, :] = 0.0
    G[:, :, dead] = 0.0
    return torch.tensor(G, dtype=torch.float32, device=DEV), dead


def unit_dead(torch, X):
    """X with every dead-pivot row and column replaced by the identity's:
    the input on which one library call computes the kernel's function
    (the kernels zero those rows, the library call would fail on them)."""
    keep = torch.diagonal(X, dim1=-2, dim2=-1) > 1e-30
    eye = torch.eye(X.shape[-1], dtype=X.dtype, device=X.device)
    return torch.where(keep[..., :, None] & keep[..., None, :], X,
                       eye).contiguous()


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def row_rel_err(torch, got, ref):
    """Largest per-row error relative to the row's scale in `ref`; a row
    that `ref` leaves exactly zero must come out exactly zero."""
    diff = (got - ref).abs().amax(-1)
    scale = ref.abs().amax(-1)
    rel = torch.where(scale > 0, diff / scale,
                      torch.where(diff > 0, float("inf"), 0.0))
    return float(rel.max())


def bound(n_bytes, n_flops):
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = n_flops / F32_FLOPS * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def check_kernels(torch, lc, captured):
    """Hold each Cholesky kernel against its plain version; time all
    three."""
    results = []
    cases = {
        "chol_lanes": (lc.chol_lanes, lc.chol_plain,
                       lambda G: torch.linalg.cholesky_ex(G)[0]),
        "chol_inv_lanes": (lc.chol_inv_lanes, lc.chol_inv_plain, None),
        "tri_inv_lanes": (lc.tri_inv_lanes, lc.tri_inv_plain,
                          lambda L: torch.linalg.solve_triangular(
                              L, torch.eye(L.shape[-1], device=L.device)
                              .expand(L.shape), upper=False)),
    }
    for name, (kernel, plain, library) in cases.items():
        inputs = [args[0] for args in captured[name]]
        real = inputs[-1]
        batch, m, _ = real.shape
        rnd, dead = random_psd(torch, batch, m, seed=len(results))
        if name == "tri_inv_lanes":
            rnd = lc.chol_plain(rnd) + torch.diag_embed(
                torch.where(torch.diagonal(rnd, dim1=-2, dim2=-1) > 0,
                            1.0, 0.0))
        rnd = rnd.contiguous()
        err = 0.0
        rel = {"real": 0.0, "random": 0.0}
        rel_plain, use = 0.0, 0.0   # plain's own error; worst error/limit
        for kind, X in [("real", X) for X in inputs] + [("random", rnd)]:
            got, ref = as_tuple(kernel(X)), as_tuple(plain(X))
            ref64 = as_tuple(plain(X.double()))
            torch.cuda.synchronize()
            for g, r, r64 in zip(got, ref, ref64):
                if not torch.isfinite(g).all():
                    raise AssertionError(f"{name}: non-finite output")
                err = max(err, float((g - r).abs().max()))
                e = row_rel_err(torch, g, r)
                e_plain = row_rel_err(torch, r.double(), r64)
                limit = min(ROW_TOL + ROW_TOL_SCALE * e_plain, ROW_TOL_CAP)
                rel[kind] = max(rel[kind], e)
                rel_plain = max(rel_plain, e_plain)
                use = max(use, e / limit)
        print(f"kernel {name}: row-relative error real {rel['real']:.3e} "
              f"random {rel['random']:.3e}; plain float32 vs float64 "
              f"{rel_plain:.3e}; worst error / limit {use:.3f}", flush=True)
        if use > 1.0:
            raise AssertionError(f"{name}: row-relative error above its "
                                 f"limit ({use:.3f} x)")
        # rows and columns that are exactly zero stay exactly zero
        for g in as_tuple(kernel(rnd)):
            if (g[:, dead, :].abs().max() != 0
                    or g[:, :, dead].abs().max() != 0):
                raise AssertionError(f"{name}: planted zero rows leaked")
        X = real.contiguous()
        ms = cuda_ms(torch, lambda: kernel(X))
        plain_ms = cuda_ms(torch, lambda: plain(X))
        Xu = unit_dead(torch, X)
        library_ms = cuda_ms(torch, lambda: library(Xu)) if library else None
        # each kernel reads the lower triangle of its input and writes
        # whole (m, m) outputs
        n_out = {"chol_lanes": 1, "chol_inv_lanes": 2, "tri_inv_lanes": 1}
        moved = batch * (m * (m + 1) // 2 + n_out[name] * m * m) * 4
        bound_ms, bound_by = bound(moved, n_out[name] * batch * m ** 3 / 3.0)
        results.append(dict(
            name=name, route="cuda",
            source="xivo_tpu_torch/csrc/lanes_chol.cu",
            replaces=REPLACES[name], launches=None, max_abs_err=err,
            row_rel_err=max(rel.values()), ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms, shape=[batch, m, m]))
        print(f"kernel {name}: shape {batch}x{m}x{m} max_abs_err {err:.3e} "
              f"ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms {library_ms} "
              f"bound_ms {bound_ms:.4f} ({bound_by})", flush=True)
    return results


# ---------------------------------------------------------------------------
# the image path's LK kernels
# ---------------------------------------------------------------------------

def texture(H, W, seed, dx=0.0, dy=0.0):
    """A smooth random image (a sum of plane waves) sampled at x + dx,
    y + dy: the same scene moved by (-dx, -dy). The LK kernels' tests use
    it too."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    img = np.zeros((H, W))
    amps = rng.uniform(10.0, 30.0, 12)
    for a in amps:
        kx, ky = rng.uniform(-0.35, 0.35, 2)
        img += a * np.sin(kx * (xs + dx) + ky * (ys + dy)
                          + rng.uniform(0.0, 2 * np.pi))
    return (128.0 + 100.0 * img / amps.sum()).astype(np.float32)


def texture_lk_inputs(torch, lko, cfg, batch, n):
    """The (B4, B5) inputs of every level of one LK call on `batch`
    random textures moved by a few pixels, `n` tracks each."""
    from xivo_tpu_torch.frontend import lk as flk
    from xivo_tpu_torch.frontend.image import build_pyramid
    H, W = 256, 256
    rng = np.random.default_rng(11)
    img0 = np.stack([texture(H, W, b) for b in range(batch)])
    img1 = np.stack([texture(H, W, b, *rng.uniform(-5.0, 5.0, 2))
                     for b in range(batch)])
    pts = torch.tensor(rng.uniform(16, H - 16, (batch, n, 2)),
                       dtype=torch.float32, device=DEV)
    valid = torch.tensor(rng.uniform(size=(batch, n)) < 0.9, device=DEV)
    levels = cfg.klt_max_level
    with Recorder(torch, lko, ["sample_templates", "gn_tracks"]) as seen:
        flk.track(build_pyramid(torch.tensor(img0, device=DEV), levels),
                  build_pyramid(torch.tensor(img1, device=DEV), levels),
                  pts, pts, valid, win_size=cfg.klt_win_size,
                  iters=cfg.klt_max_iter, eps=cfg.klt_eps)
    torch.cuda.synchronize()
    return seen


def gn_iterations(lko, args):
    """GN iterations this input needs, summed over its tracks: one pass of
    the plain loop, a step at a time (its state is (pt, st)), counting the
    tracks not yet done before each step."""
    sp, T, Gx, Gy, sc, pt, st, iters = args
    n = 0
    for _ in range(iters):
        n = n + (st[..., 0] < 0.5).sum()
        pt, st = lko.gn_tracks_plain(sp, T, Gx, Gy, sc, pt, st, 1)
    return int(n)


def check_lk_kernels(torch, lko, captured, random_inputs, cfg):
    """Hold B4 and B5 against their plain versions; time both."""
    eps = cfg.klt_eps
    results = []

    # B4: template windows
    real = captured["sample_templates"]
    tp = real[-1][0]
    M, S, w = tp.shape[0] * tp.shape[1], tp.shape[-1], real[-1][4]
    rng = np.random.default_rng(3)
    rnd = tuple(torch.tensor(rng.uniform(-300, 300, tp.shape),
                             dtype=torch.float32, device=DEV)
                for _ in range(3)) + (torch.tensor(
                    rng.uniform(-1.0, S - w + 1.0, tp.shape[:-2] + (2,)),
                    dtype=torch.float32, device=DEV), w)
    worst = {"real": 0.0, "random": 0.0}
    err = 0.0
    for kind, args in ([("real", a) for a in real]
                       + [("random", a) for a in random_inputs[
                           "sample_templates"]] + [("random", rnd)]):
        got = lko.sample_templates(*args)
        ref = lko.sample_templates_plain(*args)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            if not torch.isfinite(g).all():
                raise AssertionError("lk_sample_templates: non-finite")
            d = (g - r).abs()
            err = max(err, float(d.max()))
            scale = r.abs().amax(dim=(-2, -1))
            rel = torch.where(scale > 0, d.amax(dim=(-2, -1)) / scale,
                              torch.where(d.amax(dim=(-2, -1)) > 0,
                                          float("inf"), 0.0))
            worst[kind] = max(worst[kind], float(rel.max()))
    print(f"kernel lk_sample_templates: per-track relative error real "
          f"{worst['real']:.3e} random {worst['random']:.3e} (limit "
          f"{TMPL_TOL:g})", flush=True)
    if max(worst.values()) > TMPL_TOL:
        raise AssertionError("lk_sample_templates disagrees with its plain "
                             "version")
    args = real[-1]
    ms = cuda_ms(torch, lambda: lko.sample_templates(*args))
    plain_ms = cuda_ms(torch, lambda: lko.sample_templates_plain(*args))
    # the library yardstick: grid_sample of the three patches as channels
    # at the same clipped sample points (bilinear, border, corners aligned)
    F = torch.nn.functional
    chans = torch.stack([a.reshape(M, S, S) for a in args[:3]], dim=1)
    start = args[3].reshape(M, 2).clamp(0.0, S - w - 1 + 0.999)
    ar = torch.arange(w, device=DEV, dtype=torch.float32)
    gx = (start[:, 0, None, None] + ar[None, None, :]).expand(M, w, w)
    gy = (start[:, 1, None, None] + ar[None, :, None]).expand(M, w, w)
    grid = (torch.stack([gx, gy], dim=-1) * (2.0 / (S - 1)) - 1.0)

    def library():
        return F.grid_sample(chans, grid, mode="bilinear",
                             padding_mode="border", align_corners=True)
    lib_err = float((library()[:, 0] - lko.sample_templates_plain(*args)[0]
                     .reshape(M, w, w)).abs().max())
    library_ms = cuda_ms(torch, library)
    # least bytes: the (w + 1)^2 entries it needs of each of its three
    # patches and its position, read once; three w x w windows written.
    # Operations: 9 per window entry (two row lerps, one column lerp).
    n_bytes = M * (3 * (w + 1) ** 2 + 2) * 4 + 3 * M * w * w * 4
    bound_ms, bound_by = bound(n_bytes, 27 * M * w * w)
    print(f"kernel lk_sample_templates: shape {M}x{S}x{S} -> 3x{M}x{w}x{w} "
          f"max_abs_err {err:.3e} ms {ms:.4f} plain_ms {plain_ms:.4f} "
          f"library_ms {library_ms:.4f} (grid_sample, max |diff| vs plain "
          f"{lib_err:.2e}) bound_ms {bound_ms:.5f} ({bound_by})", flush=True)
    results.append(dict(
        name="lk_sample_templates", route="cuda",
        source="xivo_tpu_torch/csrc/lk.cu", replaces=REPLACES[
            "lk_sample_templates"], launches=None, max_abs_err=err,
        row_rel_err=max(worst.values()), ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
        shape=[M, S, S]))

    # B5: the Gauss-Newton loop
    stats = {"live": 0, "flags_differ": 0, "converged": 0,
             "unconverged": 0}
    dconv = dunconv = dsame = 0.0
    for args in captured["gn_tracks"] + random_inputs["gn_tracks"]:
        sp, T, Gx, Gy, sc, pt, st, iters = args
        pk, sk = lko.gn_tracks(*args)
        pp, spl = lko.gn_tracks_plain(*args)
        torch.cuda.synchronize()
        if not torch.isfinite(pk).all():
            raise AssertionError("lk_gn_tracks: non-finite positions")
        live = st[..., 0] < 0.5
        same = (sk == spl).all(dim=-1) & live
        conv = same & (spl[..., 0] > 0.5) & (spl[..., 1] < 0.5)
        unconv = same & (spl[..., 0] < 0.5)
        d = (pk - pp).abs().amax(dim=-1)
        n_live, n_same = int(live.sum()), int(same.sum())
        stats["live"] += n_live
        stats["flags_differ"] += n_live - n_same
        stats["converged"] += int(conv.sum())
        stats["unconverged"] += int(unconv.sum())
        if n_same < GN_FLAG_SHARE * n_live:
            raise AssertionError(f"lk_gn_tracks: flags differ on "
                                 f"{n_live - n_same} of {n_live} tracks")
        dconv = max(dconv, float(torch.where(conv, d, 0.0).max()))
        dunconv = max(dunconv, float(torch.where(unconv, d, 0.0).max()))
        dsame = max(dsame, float(torch.where(same, d, 0.0).max()))
        lo, hi = sc[..., 4:6], sc[..., 6:8]
        inbox = ((pk >= lo) & (pk <= hi)).all(dim=-1)
        if not bool((inbox | ~live).all()):
            raise AssertionError("lk_gn_tracks: an iterate left its box")
        if not (torch.equal(pk[~live], pt[~live])
                and torch.equal(sk[~live], st[~live])):
            raise AssertionError("lk_gn_tracks: a done track moved")
    print(f"kernel lk_gn_tracks: {stats['live']} live tracks, flags differ "
          f"on {stats['flags_differ']} (limit "
          f"{(1 - GN_FLAG_SHARE) * 100:.1f} %); converged in both "
          f"{stats['converged']}, max |dpos| {dconv:.3e} px (limit "
          f"{2 * eps:g}); unconverged in both {stats['unconverged']}, max "
          f"|dpos| {dunconv:.3e} px (limit {GN_UNCONV_TOL:g})", flush=True)
    if dconv >= 2 * eps:
        raise AssertionError("lk_gn_tracks: converged positions disagree")
    if dunconv >= GN_UNCONV_TOL:
        raise AssertionError("lk_gn_tracks: unconverged positions disagree")
    args = captured["gn_tracks"][-1]
    sp, T, Gx, Gy, sc, pt, st, iters = args
    ms = cuda_ms(torch, lambda: lko.gn_tracks(*args))
    plain_ms = cuda_ms(torch, lambda: lko.gn_tracks_plain(*args))
    M, S, w = T.shape[0] * T.shape[1], sp.shape[-1], T.shape[-1]
    n_live = int((st[..., 0] < 0.5).sum())
    n_iter = gn_iterations(lko, args)
    # least bytes: a live track reads T, Gx, Gy, one (w + 1)^2 window of
    # its search patch, its 9 scalars, position and state; every track
    # reads and writes its position and state. Operations, per iteration
    # this data ran: 14 per window entry (bilinear 9, residual 1, two
    # multiply-adds) and ~20 for the 2 x 2 step.
    n_bytes = (n_live * (3 * w * w + (w + 1) ** 2 + 9) + M * 8) * 4
    bound_ms, bound_by = bound(n_bytes, n_iter * (14 * w * w + 20))
    print(f"kernel lk_gn_tracks: shape {M}x{S}x{S}, {n_live} live tracks, "
          f"{n_iter} iterations in all ({iters} at most each) ms {ms:.4f} "
          f"plain_ms {plain_ms:.4f} library_ms None bound_ms "
          f"{bound_ms:.5f} ({bound_by})", flush=True)
    results.append(dict(
        name="lk_gn_tracks", route="cuda", source="xivo_tpu_torch/csrc/lk.cu",
        # max_abs_err: positions of the tracks whose flags agree
        replaces=REPLACES["lk_gn_tracks"], launches=None, max_abs_err=dsame,
        flags_differ=stats["flags_differ"], live_tracks=stats["live"],
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, shape=[M, S, S], gn_iterations=n_iter))
    return results


def image_config():
    from xivo_tpu_torch.filter.config import config_from_json
    from xivo_tpu_torch.filter.layout import Dims
    from xivo_tpu_torch.sim.configs import IMG_BENCH_CFG, IMG_BENCH_DIMS
    return config_from_json(IMG_BENCH_CFG, dtype="float32",
                            propagation_mode="fast", covariance_form="sqrt",
                            dims=Dims(**IMG_BENCH_DIMS))


def counted(torch, kernels, fn):
    """Run fn with every launch counter at 0 and the sync debug mode set
    to raise; return (fn's result, wall s, launches by kernel)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    # the frame loop must never wait for the device: any PyTorch call that
    # synchronizes (.item(), a copy from pageable memory, ...) raises here
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, {k.name: k.launches for k in kernels}


def pcw_config():
    from xivo_tpu_torch.filter.config import config_from_json
    from xivo_tpu_torch.sim.configs import PCW_CFG
    return config_from_json(PCW_CFG, dtype="float32",
                            sim_initialize_depths=True,
                            propagation_mode="fast", covariance_form="sqrt")


def pcw_phases(torch, lc):
    """Phases 3-5: returns the B1-B3 JSON entries."""
    from xivo_tpu_torch.runner import run_batch
    cfg = pcw_config()
    assert cfg.dims.full == 228

    # phase 3: a few frames with the kernels' inputs recorded
    names = [k.name for k in lc.KERNELS]
    with Recorder(torch, lc, names) as captured:
        s, fib, _ = make_run(cfg, torch, DEV, B, frames=CAPTURE_FRAMES)
        run_batch(cfg, s, fib)
        torch.cuda.synchronize()
    kernels = check_kernels(torch, lc, captured)
    del captured

    # phase 4: CUDA kernels vs the CPU path on a small batch
    s, fib, _ = make_run(cfg, torch, DEV, 2, frames=10)
    _, out_gpu = run_batch(cfg, s, fib)
    s, fib, _ = make_run(cfg, torch, "cpu", 2, frames=10)
    _, out_cpu = run_batch(cfg, s, fib)
    dpos = float((out_gpu.Tsb.cpu() - out_cpu.Tsb).abs().max())
    print(f"cuda vs cpu path, 10 frames: max |dTsb| {dpos:.3e} m", flush=True)
    if not dpos < 1e-3:
        raise AssertionError(f"CUDA path disagrees with the CPU path: {dpos}")

    # phase 5: the main path, counted
    s, fib, gt = make_run(cfg, torch, DEV, B)
    T = int(fib.frame_dt.shape[1])
    (s, outs), wall, launches = counted(
        torch, lc.KERNELS, lambda: run_batch(cfg, s, fib))
    Tsb = outs.Tsb.cpu().numpy()
    if not np.isfinite(Tsb).all() or not torch.isfinite(outs.Rsb).all():
        raise AssertionError("non-finite poses")
    err = np.linalg.norm(Tsb[0] - gt["Tsb"], axis=1)
    ate = float(np.sqrt(np.mean(err ** 2)))
    print(f"main path: B={B} T={T} D={cfg.dims.full} wall {wall:.3f} s "
          f"frames/s {B * T / wall:.1f} ATE-RMSE(seq 0) {ate:.5f} m "
          f"launches {launches} peak_mem_GB "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", flush=True)
    if not ate < ATE_BOUND:
        raise AssertionError(f"ATE {ate} >= {ATE_BOUND}")
    for name, n in launches.items():
        if n != T:
            raise AssertionError(f"{name} launched {n} times, expected {T}")
    for k in kernels:
        k["launches"] = launches[k["name"]]
    return kernels


def image_phases(torch, lc, lko):
    """Phases 6-8: returns the B4-B5 JSON entries and the launches of
    every kernel on the image main path."""
    from xivo_tpu_torch.runner import run_batch_image
    from xivo_tpu_torch.sim.image_stream import build_image_stream
    cfg = image_config()
    assert cfg.dims.full == 228 and tuple(cfg.cam_params[:2]) == (512, 512)
    t0 = time.time()
    stream = build_image_stream(cfg)
    n_frames = stream[0].image.shape[0]
    print(f"image stream: {n_frames} frames of "
          f"{stream[0].image.shape[1]}x{stream[0].image.shape[2]} rendered "
          f"in {time.time() - t0:.1f} s", flush=True)

    # phase 6: a few frames with the LK kernels' inputs recorded
    with Recorder(torch, lko, ["sample_templates", "gn_tracks"]) as captured:
        s, f, fib = make_image_run(cfg, torch, DEV, IMG_B, stream,
                                   frames=IMG_CAPTURE_FRAMES)
        run_batch_image(cfg, s, f, fib)
        torch.cuda.synchronize()
    random_inputs = texture_lk_inputs(torch, lko, cfg, IMG_B,
                                      cfg.dims.nf_rows)
    kernels = check_lk_kernels(torch, lko, captured, random_inputs, cfg)
    del captured, random_inputs

    # phase 7: CUDA image path vs the CPU image path on a small batch.
    # The bench config's admission gate keeps features out of the state
    # for the first frames, so a second case with the default gate has
    # the filter update run on image tracks from frame ~3 on.
    open_cfg = dataclasses.replace(cfg, max_depth_var_for_admission=np.inf)
    for label, c, frames in (("bench config", cfg, IMG_CMP_FRAMES),
                             ("default admission gate", open_cfg,
                              IMG_CMP_OPEN_FRAMES)):
        s, f, fib = make_image_run(c, torch, DEV, 2, stream, frames=frames)
        _, _, out_gpu = run_batch_image(c, s, f, fib)
        s, f, fib = make_image_run(c, torch, "cpu", 2, stream, frames=frames)
        _, _, out_cpu = run_batch_image(c, s, f, fib)
        dpos = float((out_gpu.Tsb.cpu() - out_cpu.Tsb).abs().max())
        same = True
        for name in ("num_tracked", "num_instate_features"):
            x = getattr(out_gpu, name).cpu().numpy()
            y = getattr(out_cpu, name).numpy()
            same &= bool((x == y).all())
            print(f"image cuda vs cpu path, {label}: {name} cuda "
                  f"{x[0].tolist()} cpu {y[0].tolist()}", flush=True)
        print(f"image cuda vs cpu path, {label}, {frames} frames: max "
              f"|dTsb| {dpos:.3e} m", flush=True)
        if not dpos < IMG_PATH_TOL or not same:
            raise AssertionError(f"the CUDA image path disagrees with the "
                                 f"CPU image path ({label})")

    # phase 8: the image main path, counted
    s, f, fib = make_image_run(cfg, torch, DEV, IMG_B, stream)
    T = int(fib.frame_dt.shape[1])
    (s, f, outs), wall, launches = counted(
        torch, lc.KERNELS + lko.KERNELS,
        lambda: run_batch_image(cfg, s, f, fib))
    Tsb = outs.Tsb.cpu().numpy()
    if not np.isfinite(Tsb).all() or not torch.isfinite(outs.Rsb).all():
        raise AssertionError("non-finite poses")
    gt = stream[1]
    err = np.linalg.norm(Tsb[0] - gt["Tsb"], axis=1)
    ntr = outs.num_tracked.cpu().numpy()
    inst = outs.num_instate_features.cpu().numpy()
    print(f"image main path: B={IMG_B} T={T} 512x512 D={cfg.dims.full} "
          f"wall {wall:.3f} s sequence-frames/s {IMG_B * T / wall:.1f} "
          f"peak_mem_GB {torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"launches {launches}", flush=True)
    print(f"image main path, sequence 0: final error {err[-1]:.4f} m "
          f"(bound {IMG_FINAL_BOUND}), median {np.median(err):.4f} m (bound "
          f"{IMG_MEDIAN_BOUND}), RMSE {np.sqrt(np.mean(err ** 2)):.4f} m; "
          f"tracked from frame 10 at least {int(ntr[0, 10:].min())} "
          f"(bound {IMG_MIN_TRACKED}); features in the state from frame "
          f"{int(np.argmax(inst[0] > 0)) if inst[0].any() else None}, "
          f"{int(inst[0, -1])} at the end; "
          f"all sequences: final error "
          f"{np.linalg.norm(Tsb[:, -1] - gt['Tsb'][-1], axis=1).max():.4f}"
          f" m at most", flush=True)
    if not (err[-1] < IMG_FINAL_BOUND and np.median(err) < IMG_MEDIAN_BOUND
            and ntr[0, 10:].min() >= IMG_MIN_TRACKED):
        raise AssertionError("image path outside the reference's bounds")
    expect = {k.name: T for k in lc.KERNELS}
    expect.update({k.name: cfg.klt_max_level * T for k in lko.KERNELS})
    if launches != expect:
        raise AssertionError(f"launches {launches}, expected {expect}")
    for k in kernels:
        k["launches"] = launches[k["name"]]
    return kernels, launches


class Timed:
    """Replace module functions by wrappers that synchronize the card
    before and after each call and add its wall time to a total by stage,
    while the `with` block runs."""

    def __init__(self, torch, patches):
        self.torch, self.patches = torch, patches   # [(module, name)]
        self.total = {name: 0.0 for _, name in patches}

    def __enter__(self):
        self.orig = [(m, n, getattr(m, n)) for m, n in self.patches]
        for m, n, fn in self.orig:
            setattr(m, n, self._wrap(n, fn))
        return self.total

    def _wrap(self, name, fn):
        def timed(*args, **kw):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            self.torch.cuda.synchronize()
            self.total[name] += time.perf_counter() - t0
            return out
        return timed

    def __exit__(self, *exc):
        for m, n, fn in self.orig:
            setattr(m, n, fn)


def where_time_goes(torch, label, run, stages, n_frames):
    """Phase 9 for one main path: `run()` runs the profiled window of
    `n_frames` frame steps; `stages` are the (module, function) pairs of
    the frame step to time one by one."""
    from torch.profiler import ProfilerActivity, profile
    run()                                  # warm: same shapes, same code
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) is None or \
                "CUDA" not in str(e.device_type):
            continue
        t = getattr(e, "self_device_time_total", 0.0) or 0.0
        if t > 0:
            by_kernel[e.key] = (t / 1e3 / n_frames, e.count // n_frames)
    busy = sum(t for t, _ in by_kernel.values())
    step = wall / n_frames * 1e3
    if busy > 0:
        print(f"{label} time: frame step {step:.2f} ms (wall over "
              f"{n_frames} steps, profiled), device busy {busy:.2f} ms a "
              f"step ({100 * busy / step:.1f} %), idle "
              f"{100 * (1 - busy / step):.1f} %; "
              f"{sum(c for _, c in by_kernel.values())} kernel launches a "
              f"step", flush=True)
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])
        own = [kv for kv in top
               if any(f"::{k}(" in kv[0] for k in OWN_KERNELS)]
        for name, (t, c) in top[:12] + [kv for kv in own
                                         if kv not in top[:12]]:
            print(f"{label} time:   {t:8.4f} ms a step, {c:4d} launches: "
                  f"{name[:90]}", flush=True)
    else:
        print(f"{label} time: frame step {step:.2f} ms; the profiler saw no "
              f"device time (busy share not measured)", flush=True)
    with Timed(torch, stages) as total:
        run()
    print(f"{label} time, each stage synchronized: " + ", ".join(
        f"{n} {t / n_frames * 1e3:.2f} ms" for n, t in total.items())
        + " a step", flush=True)


def breakdown_phase(torch, pcw_cfg):
    """Phase 9: where the frame step's time goes, on both main paths."""
    from xivo_tpu_torch.filter import pipeline
    from xivo_tpu_torch.frontend import brief, tracker
    from xivo_tpu_torch.runner import run_batch, run_batch_image
    from xivo_tpu_torch.sim.image_stream import build_image_stream
    a, b = PROFILE_FRAMES
    n = b - a

    s, fib, _ = make_run(pcw_cfg, torch, DEV, B, frames=b)
    s, _ = run_batch(pcw_cfg, s, type(fib)(*(x[:, :a] for x in fib)))
    win = type(fib)(*(x[:, a:b] for x in fib))
    where_time_goes(torch, f"pcw B={B}", lambda: run_batch(pcw_cfg, s, win),
                    [(pipeline, "propagate_frame"),
                     (pipeline, "tracker_pointcloud"),
                     (pipeline, "update_step")], n)

    cfg = image_config()
    stream = build_image_stream(cfg)
    s, f, fib = make_image_run(cfg, torch, DEV, IMG_B, stream, frames=b)
    s, f, _ = run_batch_image(cfg, s, f, type(fib)(*(x[:, :a] for x in fib)))
    win = type(fib)(*(x[:, a:b] for x in fib))
    where_time_goes(
        torch, f"image B={IMG_B}",
        lambda: run_batch_image(cfg, s, f, win),
        [(tracker, "propagate_frame"), (tracker, "tracker_image"),
         (tracker, "build_pyramid"), (tracker, "track"),
         (tracker, "fast_score"), (tracker, "select_topk"),
         (brief, "extract"), (tracker, "update_step")], n)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import xivo_tpu_torch  # noqa: F401  (sets the TF32 switches)
    from xivo_tpu_torch.ops import lanes_chol as lc
    from xivo_tpu_torch.ops import lk as lko

    t_start = time.time()
    card = card_line()
    print(f"card: {card}", flush=True)
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is on"
    assert not torch.backends.cudnn.allow_tf32, "TF32 cuDNN is on"

    t0 = time.time()
    built = build_kernels()
    print(f"build: {sorted(built)} in {time.time() - t0:.1f} s", flush=True)

    kernels = pcw_phases(torch, lc)
    print(f"pcw phases done: {time.time() - t_start:.1f} s", flush=True)
    lk_kernels, img_launches = image_phases(torch, lc, lko)
    breakdown_phase(torch, pcw_config())
    for k in kernels:
        k["launches_image_path"] = img_launches[k["name"]]
    kernels += lk_kernels
    print(f"elapsed: {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
