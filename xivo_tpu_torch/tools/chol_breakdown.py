"""Where the blocked Cholesky kernel's time goes, on the card.

Builds ``csrc/chol_blocked.cu`` as it is and with one step of it (or
several) cut out of the source, and times each build on the same random
PSD batch. A cut build computes a wrong factor; its time says how much
the step costs where it stands, overlap included: the saving is the full
kernel's time less the cut one's.

    python -m xivo_tpu_torch.tools.chol_breakdown [--batch 256]
        [--widths 228,60]

Steps:
- ``trailing``: the trailing update (the SYRK of every panel);
- ``solve``: the rows below each panel's diagonal block;
- ``block``: warp 0's update and factorization of the next diagonal
  block (the look-ahead, with its pivot chain);
- ``store``: every write of L and of the zero upper triangle;
- ``load``: the copy of the lower triangle into shared memory;
- ``all``: the five together (what is left: launch, tile list, barriers).

Times are ms per launch from CUDA events, the card held by a sleep kernel
while the host enqueues (as ``chip_smoke.py`` times every kernel). Needs
a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..ops import _build

SOURCE = os.path.join(_build.CSRC, "chol_blocked.cu")
OUT_DIR = os.path.join(_build.BUILD_DIR, "breakdown")

# each step's lines of the kernel, cut out exactly as they stand
CUTS = {
    "trailing": ["            if (n0 < m) trailing_update(A, tiles, m, mp, "
                 "c0);\n"],
    "solve": ["        if (n0 < m) solve_below(A, blk, m, mp, c0);\n"],
    "block": ["            if (n0 < m)\n                factor_block(A, "
              "blocks + ((p + 1) & 1) * kBlock, mp, c0, n0,\n"
              "                             min(kT, m - n0));\n"],
    "store": ["            store_panel(A, blk, out, m, mp, c0, w);\n",
              "    zero_upper(out, m);\n"],
    "load": ["    load_rows(in, A, m, mp, 0, min(kT, m));\n",
             "    load_rows(in, A, m, mp, kT, m);\n"],
}
STEPS = ("full",) + tuple(CUTS) + ("all",)


def variant_source(step: str) -> str:
    with open(SOURCE) as f:
        src = f.read()
    cuts = [] if step == "full" else (
        sum(CUTS.values(), []) if step == "all" else CUTS[step])
    for line in cuts:
        if line not in src:
            raise RuntimeError(f"{step}: the kernel no longer has the line "
                               f"{line!r}; update CUTS")
        src = src.replace(line, "")
    return src


def build(step: str) -> str:
    os.makedirs(OUT_DIR, exist_ok=True)
    src = os.path.join(OUT_DIR, f"{step}.cu")
    with open(src, "w") as f:
        f.write(variant_source(step))
    out = os.path.join(OUT_DIR, f"lib{step}.so")
    res = subprocess.run(
        [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", out,
         src], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on the {step} build:\n{res.stderr}")
    return out


def load(path: str):
    lib = ctypes.CDLL(path)
    lib.xivo_chol_blocked_init.restype = ctypes.c_int
    fn = lib.xivo_chol_blocked_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if lib.xivo_chol_blocked_init() != 0:
        raise RuntimeError(f"{path}: kernel set-up failed")
    return fn


def device_ms(fn, reps=20) -> float:
    """Mean device ms of fn() over reps calls, the card held by a sleep
    kernel while the host enqueues them."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * (2 * host_s + 0.005)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def breakdown(batch: int = 256, widths=(228, 60), seed: int = 0):
    """{width: {step: ms}}."""
    with ThreadPoolExecutor(len(STEPS)) as pool:
        fns = dict(zip(STEPS, map(load, pool.map(build, STEPS))))
    rng = np.random.default_rng(seed)
    res = {}
    for m in widths:
        A = rng.standard_normal((batch, m, m)) / np.sqrt(m)
        G = torch.tensor(A @ A.transpose(0, 2, 1) + 0.1 * np.eye(m),
                         dtype=torch.float32, device="cuda")
        out = torch.empty_like(G)
        stream = torch.cuda.current_stream().cuda_stream
        res[m] = {}
        for step, fn in fns.items():
            def launch(fn=fn):
                if fn(G.data_ptr(), out.data_ptr(), batch, m, stream) != 0:
                    raise RuntimeError(f"{step}: launch failed")
            res[m][step] = device_ms(launch)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--widths", default="228,60")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chol_breakdown: needs a CUDA card", file=sys.stderr)
        return 1
    widths = tuple(int(w) for w in args.widths.split(","))
    res = breakdown(args.batch, widths)
    for m, times in res.items():
        full = times["full"]
        for step, ms in times.items():
            print(f"chol_breakdown: B={args.batch} m={m} {step:8s} "
                  f"{ms:.4f} ms" + ("" if step == "full" else
                                    f" (saves {full - ms:.4f} ms)"),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
