"""Where the blocked Cholesky and inverse kernels' time goes, on the card.

Builds ``csrc/chol_blocked.cu`` as it is and with one step of it (or
several) cut out of the source, and times each build on the same random
inputs: the Cholesky (B1/B7, ``xivo_chol_blocked_f32``) at ``--widths``,
and L with L^-1 (B2, ``xivo_chol_inv_f32``) and a triangle's inverse (B3,
``xivo_tri_inv_f32``) at ``--inv-widths``. A cut build computes a wrong
result; its time says how much the step costs where it stands, overlap
included: the saving is the full kernel's time less the cut one's.

    python -m xivo_tpu_torch.tools.chol_breakdown [--batch 256]
        [--widths 228,60] [--inv-widths 60,120] [--parent DIR]

Steps:
- ``trailing``: the trailing update (the SYRK of every panel);
- ``solve``: the rows below each panel's diagonal block;
- ``block``: warp 0's update and factorization of the next diagonal
  block (the look-ahead, with its pivot chain);
- ``store``: every write of L, of L^-1 and of the zero upper triangle;
- ``load``: the copy of the lower triangle into shared memory;
- ``inverse``: the inversion stage of B2 and B3 (the block-row
  substitution; the Cholesky has none);
- ``all``: the six together (what is left: launch, tile list, barriers).

``--parent DIR``: DIR is another checkout of the repository (the parent
commit, unpacked with ``git archive``); its ``csrc/chol_blocked.cu`` and,
where it has one, ``csrc/lanes_chol.cu`` (where B2 and B3 lived before)
are built too, and each kernel is timed in turns: parent, this source,
the cuts, this source again, parent again, all on the same inputs; and
the largest difference between the two sources' outputs is printed (0
where they compute the same sums in the same order).

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
    "block": ["            if (n0 < m)\n                factor_block<kKeep>("
              "A, blocks + ((p + 1) & 1) * kBlock, mp,\n"
              "                                    c0, n0, min(kT, m - n0));"
              "\n"],
    "store": ["            store_panel(A, blk, out, m, mp, c0, w);\n",
              "    zero_upper(out, m);\n",
              "    store_rows(X, dst, m);\n"],
    "load": ["    load_rows(in, A, m, mp, 0, min(kT, m));\n",
             "    load_rows(in, A, m, mp, kT, m);\n",
             "    load_rows(in + off, A, m, mp, 0, m);\n"],
    "inverse": ["    invert(A, X, X + row_off(mp), m, mp);\n"],
}
STEPS = ("full",) + tuple(CUTS) + ("all",)
_p, _i = ctypes.c_void_p, ctypes.c_int
# C entry: (argument types, outputs); every input is (B, m, m) float32
ENTRIES = {"xivo_chol_blocked_f32": ([_p, _p, _i, _i, _p], 1),
           "xivo_chol_inv_f32": ([_p, _p, _p, _i, _i, _p], 2),
           "xivo_tri_inv_f32": ([_p, _p, _i, _i, _p], 1)}
INITS = ("xivo_chol_blocked_init", "xivo_lanes_chol_init")


def variant_source(step: str) -> str:
    with open(SOURCE) as f:
        src = f.read()
    cuts = [] if step == "full" else (
        sum(CUTS.values(), []) if step == "all" else CUTS[step])
    for line in cuts:
        if src.count(line) != 1:
            raise RuntimeError(f"{step}: the kernel no longer has the line "
                               f"{line!r} once; update CUTS")
        src = src.replace(line, "")
    return src


def nvcc(src: str, out: str) -> str:
    res = subprocess.run(
        [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", out,
         src], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stderr}")
    return out


def build(step: str) -> str:
    os.makedirs(OUT_DIR, exist_ok=True)
    src = os.path.join(OUT_DIR, f"{step}.cu")
    with open(src, "w") as f:
        f.write(variant_source(step))
    return nvcc(src, os.path.join(OUT_DIR, f"lib{step}.so"))


def build_parent(root: str):
    """The parent checkout's sources of these kernels, one library each."""
    csrc = os.path.join(root, "xivo_tpu_torch", "csrc")
    names = [n for n in ("chol_blocked", "lanes_chol")
             if os.path.exists(os.path.join(csrc, f"{n}.cu"))]
    os.makedirs(OUT_DIR, exist_ok=True)
    return [nvcc(os.path.join(csrc, f"{n}.cu"),
                 os.path.join(OUT_DIR, f"libparent_{n}.so")) for n in names]


def load(paths):
    """{C entry: function} over the libraries at `paths`, each set up."""
    fns = {}
    for path in paths:
        lib = ctypes.CDLL(path)
        for init in INITS:
            if hasattr(lib, init):
                getattr(lib, init).restype = ctypes.c_int
                if getattr(lib, init)() != 0:
                    raise RuntimeError(f"{path}: kernel set-up failed")
        for name, (argtypes, _) in ENTRIES.items():
            if hasattr(lib, name):
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
                fns[name] = fn
    return fns


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


def inputs(entry, batch, m, rng):
    """A well-conditioned PSD batch (for B1/B7 and B2) or its Cholesky
    factor (for B3), on the card."""
    A = rng.standard_normal((batch, m, m)) / np.sqrt(m)
    G = torch.tensor(A @ A.transpose(0, 2, 1) + 0.1 * np.eye(m),
                     dtype=torch.float32, device="cuda")
    if entry == "xivo_tri_inv_f32":
        G = torch.linalg.cholesky(G).contiguous()
    return G


def breakdown(batch: int = 256, widths=(228, 60), inv_widths=(60, 120),
              parent: str = None, seed: int = 0):
    """{(C entry, width): {build: ms}}; "full2" (and "parent2") are the
    second turns of this source (and of the parent's), "max_diff" the
    largest difference of each output between parent and this source."""
    with ThreadPoolExecutor(len(STEPS) + 1) as pool:
        paths = list(pool.map(build, STEPS))
        par = pool.submit(build_parent, parent) if parent else None
        builds = {s: load([p]) for s, p in zip(STEPS, paths)}
        if par:
            builds["parent"] = load(par.result())
    rng = np.random.default_rng(seed)
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    jobs = [("xivo_chol_blocked_f32", m) for m in widths] + [
        (e, m) for m in inv_widths
        for e in ("xivo_chol_inv_f32", "xivo_tri_inv_f32")]
    for entry, m in jobs:
        X = inputs(entry, batch, m, rng)
        outs = [torch.empty_like(X) for _ in range(ENTRIES[entry][1])]
        order = list(STEPS) + ["full2"]
        if entry == "xivo_chol_blocked_f32":
            order.remove("inverse")
        if parent:
            order = ["parent"] + order + ["parent2"]
        res[entry, m] = {}
        if parent:
            res[entry, m]["max_diff"] = max_diff(
                [builds[b][entry] for b in ("parent", "full")], X, batch,
                m, stream, len(outs))
        for step in order:
            fn = builds[step.rstrip("2")][entry]

            def launch(fn=fn):
                if fn(X.data_ptr(), *(o.data_ptr() for o in outs), batch, m,
                      stream) != 0:
                    raise RuntimeError(f"{entry} {step}: launch failed")
            res[entry, m][step] = device_ms(launch)
    return res


def max_diff(fns, X, batch, m, stream, n_out):
    """Largest |difference| between two builds' outputs on X."""
    outs = []
    for fn in fns:
        o = [torch.empty_like(X) for _ in range(n_out)]
        if fn(X.data_ptr(), *(t.data_ptr() for t in o), batch, m,
              stream) != 0:
            raise RuntimeError("launch failed")
        outs.append(o)
    torch.cuda.synchronize()
    return [float((a - b).abs().max()) for a, b in zip(*outs)]


NAMES = {"xivo_chol_blocked_f32": "B1/B7", "xivo_chol_inv_f32": "B2",
         "xivo_tri_inv_f32": "B3"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--widths", default="228,60")
    ap.add_argument("--inv-widths", default="60,120")
    ap.add_argument("--parent", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chol_breakdown: needs a CUDA card", file=sys.stderr)
        return 1

    def ints(s):
        return tuple(int(w) for w in s.split(",") if w)
    res = breakdown(args.batch, ints(args.widths), ints(args.inv_widths),
                    args.parent)
    for (entry, m), times in res.items():
        diff = times.pop("max_diff", None)
        full = (times["full"] + times["full2"]) / 2
        for step, ms in times.items():
            note = ("" if step.startswith(("full", "parent")) else
                    f" (saves {full - ms:.4f} ms)")
            print(f"chol_breakdown: {NAMES[entry]} B={args.batch} m={m} "
                  f"{step:8s} {ms:.4f} ms{note}", flush=True)
        if "parent" in times:
            par = (times["parent"] + times["parent2"]) / 2
            print(f"chol_breakdown: {NAMES[entry]} B={args.batch} m={m} "
                  f"this source {full:.4f} ms against the parent's "
                  f"{par:.4f} ms: {par / full:.2f} x faster; outputs "
                  f"differ by at most {diff}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
