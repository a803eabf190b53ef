"""Primitive timings of the filter's linear algebra (port of
``scripts/profile_linalg.py``), B7's entry point on the card.

Each primitive runs ``iters`` times in a chain: every call's input is the
last call's input scaled by 1 + 1e-12 * mean(its output), so every call
depends on the one before (nothing is skipped) and the chain's small
elementwise kernels are part of each time, as in the reference. Times are
milliseconds per call from CUDA events after a warm-up; on the CPU
(``device="cpu"``, for rehearsal) they are host wall times and say nothing
of the card.

    python -m xivo_tpu_torch.tools.profile_linalg [--batch 256] [--iters 50]

Primitives, at batch B (float32, TF32 off):
- ``torch.linalg.cholesky_ex`` at 60 and 228 (the library yardstick);
- B7, ``ops.chol.cholesky_batched``, at 228 and 60;
- B1, ``ops.lanes_chol.chol_lanes``, the same kernel under B1's name
  (``csrc/chol_blocked.cu`` serves both), at 228 and 60;
- ``solve_triangular`` with a 60 x 60 factor against 418 and 60
  right-hand sides (``sqrt_update``'s shapes);
- the 228 x 357 Gram and the 60 x 60 @ 60 x 357 product.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import resolve_device
from ..ops import chol, lanes_chol


def _chain(x, out):
    return x * (1.0 + 1e-12 * out.mean())


def timeit(name, x0, fn, iters, device):
    """ms per call of the chained fn, after one warm-up chain."""
    def run(x):
        for _ in range(iters):
            x = _chain(x, fn(x))
        return x

    run(x0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run(x0)
        end.record()
        torch.cuda.synchronize(device)
        ms = start.elapsed_time(end) / iters
        label = "cuda"
    else:
        t0 = time.perf_counter()
        run(x0)
        ms = (time.perf_counter() - t0) / iters * 1e3
        label = "cpu wall"
    print(f"{name:36s} {ms:9.4f} ms/call ({label})", flush=True)
    return ms


def profile(batch: int = 256, iters: int = 50, device="cuda", seed=0):
    """Run every line; returns {name: ms per call}."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    def psd(m):
        A = rng.standard_normal((batch, m, m)).astype(np.float32)
        return t(A @ A.transpose(0, 2, 1) + 3 * np.eye(m, dtype=np.float32))

    G60, G228 = psd(60), psd(228)
    V = t(rng.standard_normal((batch, 60, 357)))
    S = t(rng.standard_normal((batch, 228, 357)))
    L60 = torch.linalg.cholesky(G60)
    pad = torch.zeros((batch, 60, 61), dtype=torch.float32, device=dev)

    lines = [
        ("torch cholesky_ex(60)", G60,
         lambda c: torch.linalg.cholesky_ex(c)[0]),
        ("torch cholesky_ex(228)", G228,
         lambda c: torch.linalg.cholesky_ex(c)[0]),
        ("B7 cholesky_batched(228)", G228, chol.cholesky_batched),
        ("B7 cholesky_batched(60)", G60, chol.cholesky_batched),
        ("B1 chol_lanes(228)", G228, lanes_chol.chol_lanes),
        ("B1 chol_lanes(60)", G60, lanes_chol.chol_lanes),
        ("solve_triangular(60, 418rhs)", V,
         lambda c: torch.linalg.solve_triangular(
             L60, torch.cat([c, pad], -1), upper=False)),
        ("solve_triangular(60, 60rhs)", V,
         lambda c: torch.linalg.solve_triangular(L60, c[..., :60],
                                                 upper=False)),
        ("gram 228x357 f32", S, lambda c: c @ c.transpose(-1, -2)),
        ("matmul 60x60 @ 60x357 f32", V, lambda c: L60 @ c),
    ]
    return {name: timeit(name, x0, fn, iters, dev)
            for name, x0, fn in lines}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    profile(a.batch, a.iters, a.device)


if __name__ == "__main__":
    main()
