"""Smoke test of the PyTorch/CUDA port (``xivo_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. print the card's name and power limit; check that TF32 is off;
2. build the CUDA kernels from ``xivo_tpu_torch/csrc`` (nvcc, sm_90a);
3. drive a few frames of the main path at full width and keep the inputs
   its kernels saw; hold each kernel against its plain PyTorch version on
   those real matrices and on random PSD matrices with planted zero rows,
   and time kernel, plain version and the library call (``cholesky_ex``,
   ``solve_triangular``; on the same input with its dead rows made unit);
4. check the CUDA path against the port's CPU path (plain versions) at
   full width on a small batch (B = 2, 10 frames);
5. run the main path: PCW config, float32, default Dims (D = 228), B = 256
   sequences of the 5 s stream (T = 100 frames), with every launch counter
   set to 0 just before and PyTorch's sync debug mode set to raise on any
   host sync in the frame loop; require finite poses, ATE-RMSE of
   sequence 0 below 0.10 m and one launch of each kernel per frame.

The last lines are the kernels' JSON line, the card line, and
``{"ok": true, "device": {...}}``. Without CUDA it prints no result and
exits 1.
"""
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
REPLACES = {"chol_lanes": "xivo_tpu/ops/lanes_chol.py:103",
            "chol_inv_lanes": "xivo_tpu/ops/lanes_chol.py:108",
            "tri_inv_lanes": "xivo_tpu/ops/lanes_chol.py:133"}


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def make_run(cfg, torch, device, batch, frames=None):
    """(states, inputs, gt) for `batch` copies of the bench stream."""
    from xivo_tpu_torch.runner import batch_states, inputs_to_device
    from xivo_tpu_torch.sim.stream import build_pcw_stream
    fi, gt = build_pcw_stream(cfg, total_time=TOTAL_TIME, noise_px=0.25)
    if frames is not None:
        fi = type(fi)(*(a[:frames] for a in fi))
    fib = inputs_to_device(type(fi)(*(
        np.broadcast_to(a, (batch,) + a.shape) for a in fi)), device)
    s = batch_states(cfg, batch, device)
    dt = s.P.dtype
    s = s._replace(
        last_gyro=torch.tensor(gt["gyro0"], dtype=dt,
                               device=device).expand(batch, 3).clone(),
        last_accel=torch.tensor(gt["accel0"], dtype=dt,
                                device=device).expand(batch, 3).clone())
    return s, fib, gt


def cuda_ms(torch, fn, reps=20):
    """Mean device time of fn() over reps launches, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_psd(torch, batch, m, seed):
    """Well-conditioned PSD (B, m, m) float32 with planted zero rows/cols."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((batch, m, m)) / np.sqrt(m)
    G = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(m)
    dead = rng.choice(m, size=max(1, m // 10), replace=False)
    G[:, dead, :] = 0.0
    G[:, :, dead] = 0.0
    return torch.tensor(G, dtype=torch.float32, device="cuda"), dead


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


def check_kernels(torch, lc, captured):
    """Hold each kernel against its plain version; time all three."""
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
        real = captured[name][-1]
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
        for kind, X in ([("real", X) for X in captured[name]]
                        + [("random", rnd)]):
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
        n_flop = {"chol_lanes": 1, "chol_inv_lanes": 2, "tri_inv_lanes": 1}
        moved = batch * (m * (m + 1) // 2 + n_out[name] * m * m) * 4
        t_bytes = moved / HBM_BYTES_S * 1e3
        t_ops = n_flop[name] * batch * m ** 3 / 3.0 / F32_FLOPS * 1e3
        results.append(dict(
            name=name, route="cuda",
            source="xivo_tpu_torch/csrc/lanes_chol.cu",
            replaces=REPLACES[name], launches=None, max_abs_err=err,
            row_rel_err=max(rel.values()), ms=ms,
            plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=library_ms, shape=[batch, m, m]))
        print(f"kernel {name}: shape {batch}x{m}x{m} max_abs_err {err:.3e} "
              f"ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms {library_ms} "
              f"bound_ms {max(t_bytes, t_ops):.4f}", flush=True)
    return results


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import xivo_tpu_torch  # noqa: F401  (sets the TF32 switches)
    from xivo_tpu_torch.filter.config import config_from_json
    from xivo_tpu_torch.ops import lanes_chol as lc
    from xivo_tpu_torch.runner import run_batch
    from xivo_tpu_torch.sim.configs import PCW_CFG

    t_start = time.time()
    card = card_line()
    print(f"card: {card}", flush=True)
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is on"
    assert not torch.backends.cudnn.allow_tf32, "TF32 cuDNN is on"

    t0 = time.time()
    lc.build()
    print(f"build: {time.time() - t0:.1f} s", flush=True)

    cfg = config_from_json(PCW_CFG, dtype="float32",
                           sim_initialize_depths=True,
                           propagation_mode="fast", covariance_form="sqrt")
    assert cfg.dims.full == 228

    # phase 3: a few frames with the kernels' inputs recorded
    captured = {k.name: [] for k in lc.KERNELS}
    originals = {k.name: getattr(lc, k.name) for k in lc.KERNELS}

    def recorder(name):
        def fn(X):
            captured[name].append(X.detach().clone())
            return originals[name](X)
        return fn
    for name in originals:
        setattr(lc, name, recorder(name))
    try:
        s, fib, _ = make_run(cfg, torch, "cuda", B, frames=CAPTURE_FRAMES)
        run_batch(cfg, s, fib)
        torch.cuda.synchronize()
    finally:
        for name, fn in originals.items():
            setattr(lc, name, fn)
    kernels = check_kernels(torch, lc, captured)
    del captured

    # phase 4: CUDA kernels vs the CPU path on a small batch
    s, fib, _ = make_run(cfg, torch, "cuda", 2, frames=10)
    _, out_gpu = run_batch(cfg, s, fib)
    s, fib, _ = make_run(cfg, torch, "cpu", 2, frames=10)
    _, out_cpu = run_batch(cfg, s, fib)
    dpos = float((out_gpu.Tsb.cpu() - out_cpu.Tsb).abs().max())
    print(f"cuda vs cpu path, 10 frames: max |dTsb| {dpos:.3e} m", flush=True)
    if not dpos < 1e-3:
        raise AssertionError(f"CUDA path disagrees with the CPU path: {dpos}")

    # phase 5: the main path, counted
    s, fib, gt = make_run(cfg, torch, "cuda", B)
    T = int(fib.frame_dt.shape[1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in lc.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    # the frame loop must never wait for the device: any PyTorch call that
    # synchronizes (.item(), a copy from pageable memory, ...) raises here
    torch.cuda.set_sync_debug_mode("error")
    try:
        s, outs = run_batch(cfg, s, fib)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in lc.KERNELS}
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
    print(f"elapsed: {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
