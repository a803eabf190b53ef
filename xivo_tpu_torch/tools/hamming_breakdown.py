"""Where the Hamming kernel's (B6) time goes, and how it compares with
other builds of it (the parent commit's, an earlier design's), on the card.

Builds ``csrc/hamming.cu`` as it is, with one step of it (or all) cut out
of the source, and with other launch shapes than the one it chooses from
B and F (C CTAs a cluster, G clusters a sequence): ``cluster8`` (C = 8),
``flat`` (C = 1, G filling the card: no cluster, each CTA reads the
whole mask), ``one_cta`` (C = G = 1: one CTA a sequence) and
``one_group`` (G = 1), and times each build through a wrapper like
``ops/hamming.hamming_nn`` on the same inputs. A cut build computes a
wrong result; its time says how much the step costs where it stands,
overlap included: the saving is the full kernel's time less the cut one's.

    python -m xivo_tpu_torch.tools.hamming_breakdown [--batch 64]
        [--batches 2,8,56,128] [--parent DIR [--parent DIR ...]]

Run it from the repository root: the inputs and the mapped runs are
``chip_smoke.py``'s. Inputs: the three searches of frame 130 of the
mapped main path at ``--batch`` sequences (phase 10's recorded calls; the
retirement search with its query-row mask and without it, and the closure
search) and random descriptors with every one of the 20000 entries valid
at F = 256; then, at each of ``--batches``, random descriptors with every
entry valid and a sparse map like a live one (70 contiguous valid entries
a sequence), the latter with one unmasked row a sequence and without a
mask.

Steps:
- ``scan``: the mask's loads (every list comes out empty, so nothing that
  follows the scan has work either: the saving includes theirs);
- ``stage``: the cp.async copies of the listed entries and their
  narrowing to 32-bit words;
- ``score``: the distances over the staged entries;
- ``fold``: the store of each row's key into its owner's slot through
  distributed shared memory (stored in the CTA's own slots instead);
- ``all``: the four together (what is left: launch, the query rows'
  list, the cluster barriers, the writes).

``--parent DIR`` (repeatable): DIR is another checkout of the repository
(a commit unpacked with ``git archive``); its ``csrc/hamming.cu`` is
built too and timed through its own wrapper, in turns: each other build,
this source, the cuts and variants, this source again, each other build
again. A tree whose wrapper takes no query-row mask (before the one-launch
kernel) is called as its wrapper did: the key buffer filled by
``torch.full``, one kernel, the keys split after it, every row scored.
The largest difference of the outputs from this source's is printed (on
every row, or on the unmasked rows where the input has a query-row mask).
Then the mapped path at phase 11's size (B = 2, 60 frames, fusion on, the
same RANSAC draws) runs three times, with ``ops.hamming.hamming_nn`` on
the first DIR's build, on this one, and on this one again, everything
else the same; it prints whether poses, closure rows, map count and
fusions are identical. It also prints each build's time for a mapped
frame's three searches: twice the masked retirement search and once the
closure search.

It also prints the launch's shape (C x G) this source chooses at each B.
Times are ms per call from CUDA events, the card held by a sleep kernel
while the host enqueues (as ``chip_smoke.py`` times every kernel). Needs a
CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from ..ops import _build
from ..ops import hamming as hm
from .chol_breakdown import device_ms, nvcc

SOURCE = os.path.join(_build.CSRC, "hamming.cu")
OUT_DIR = os.path.join(_build.BUILD_DIR, "hamming_breakdown")

# each step's code, replaced exactly as it stands: (old, new)
CUTS = {
    "scan": [("        if (tid < myn) first = gran[r0 + my0 + tid];\n", ""),
             ("v = tid < myn ? gran[r0 + my0 + tid] : make_uint4(0, 0, 0, "
              "0);", "v = make_uint4(0, 0, 0, 0);")],
    "stage": [("                    cp_async16(dst + c * 2,\n"
               "                               desc + ((long long)b * M + "
               "m) * kWords +\n"
               "                                   (c & 3) * 2);\n", ""),
              ("                    *(uint2*)(s_nar + c * 2) =\n"
               "                        make_uint2((uint32_t)x.x, "
               "(uint32_t)x.y);\n", "")],
    "score": [("                if (live) {\n"
               "                    if (s == 1)",
               "                if (false) {\n"
               "                    if (s == 1)")],
    "fold": [("cluster.map_shared_rank(s_key, own)[rank * fc + r - own * fc]",
              "s_key[rank * fc + r - own * fc]")],
}
_C = "    *C = best_c;\n"
_G = ("    *G = max(1, min(cap[dev][best_c] / B, (F + kMinRows - 1) / "
      "kMinRows));\n")
VARIANTS = {
    "cluster8": [(_C, "    *C = best_c = kMaxCluster;\n")],
    "flat": [(_C, "    *C = best_c = 1;\n")],
    "one_cta": [(_C, "    *C = best_c = 1;\n"), (_G, "    *G = 1;\n")],
    "one_group": [(_G, "    *G = 1;\n")],
}
# appended to every build of this source: the launch's shape
SHAPE = """
extern "C" int xivo_hamming_shape(int B, int F, int* C, int* G) {
    return (int)choose_shape(B, F, C, G);
}
"""
BUILDS = ("full",) + tuple(CUTS) + ("all",) + tuple(VARIANTS)
_p, _i = ctypes.c_void_p, ctypes.c_int
ENTRY = "xivo_hamming_nn"
# the C entry before the one-launch kernel: (q, desc, valid, keys, B, F,
# M, stream), the keys filled with (10000 << 32) beforehand
PARENT_ARGS = [_p] * 4 + [_i, _i, _i, _p]
ARGS = [_p] * 6 + [_i, _i, _i, _p]
SPARSE_VALID = 70       # a live map's valid entries a sequence (phase 10)


def variant_source(build: str) -> str:
    with open(SOURCE) as f:
        src = f.read()
    if build == "full":
        return src
    subs = (sum(CUTS.values(), []) if build == "all" else
            CUTS.get(build) or VARIANTS[build])
    for old, new in subs:
        if src.count(old) != 1:
            raise RuntimeError(f"{build}: the kernel no longer has {old!r} "
                               f"once; update CUTS")
        src = src.replace(old, new)
    return src


def build(name: str) -> str:
    os.makedirs(OUT_DIR, exist_ok=True)
    src = os.path.join(OUT_DIR, f"{name}.cu")
    with open(src, "w") as f:
        f.write(variant_source(name) + SHAPE)
    return nvcc(src, os.path.join(OUT_DIR, f"lib{name}.so"))


def shape(path: str, batch: int, F: int):
    """(C, G): the CTAs a cluster and the clusters a sequence that the
    build launches for `batch` sequences of F rows."""
    C, G = ctypes.c_int(0), ctypes.c_int(0)
    if ctypes.CDLL(path).xivo_hamming_shape(batch, F, ctypes.byref(C),
                                            ctypes.byref(G)) != 0:
        raise RuntimeError(f"{path}: occupancy query failed")
    return C.value, G.value


def load(path: str, argtypes):
    fn = getattr(ctypes.CDLL(path), ENTRY)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def wrapper(fn):
    """``ops/hamming.hamming_nn``'s launch on a given build (no checks)."""
    def call(q, desc, valid, qmask=None):
        B, F, _ = q.shape
        dist = torch.empty((B, F), dtype=torch.int64, device=q.device)
        idx = torch.empty_like(dist)
        if fn(q.data_ptr(), desc.data_ptr(), valid.data_ptr(),
              None if qmask is None else qmask.data_ptr(), dist.data_ptr(),
              idx.data_ptr(), B, F, desc.shape[1], _build.stream(q)) != 0:
            raise RuntimeError("hamming_nn: launch failed")
        return dist, idx
    return call


def parent_wrapper(fn):
    """The wrapper before the one-launch kernel: keys filled, one kernel,
    keys split; it has no query-row mask and scores every row."""
    def call(q, desc, valid, qmask=None):
        B, F, _ = q.shape
        best = torch.full((B, F), hm.NO_MATCH << 32, dtype=torch.int64,
                          device=q.device)
        if fn(q.data_ptr(), desc.data_ptr(), valid.data_ptr(),
              best.data_ptr(), B, F, desc.shape[1], _build.stream(q)) != 0:
            raise RuntimeError("hamming_nn (parent): launch failed")
        return best >> 32, best & 0xFFFFFFFF
    return call


def other_build(tree: str, name: str):
    """(label, call) of another tree's kernel through its own wrapper."""
    pkg = os.path.join(tree, "xivo_tpu_torch")
    with open(os.path.join(pkg, "ops", "hamming.py")) as f:
        masked = "qmask" in f.read()
    path = nvcc(os.path.join(pkg, "csrc", "hamming.cu"),
                os.path.join(OUT_DIR, f"lib_{name}.so"))
    return (wrapper(load(path, ARGS)) if masked else
            parent_wrapper(load(path, PARENT_ARGS)))


def sparse_inputs(batch: int, seed: int):
    """Random descriptors at M = 20000, F = 256 with a live map's valid
    entries (SPARSE_VALID contiguous ones a sequence, where a ring buffer
    keeps them) and one unmasked row a sequence."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    M, F = 20000, 256
    q, d = (torch.randint(0, 2 ** 32, shape, generator=g, device="cuda",
                          dtype=torch.int64) for shape in ((batch, F, 8),
                                                           (batch, M, 8)))
    at = torch.randint(0, M - SPARSE_VALID, (batch, 1), generator=g,
                       device="cuda")
    m = torch.arange(M, device="cuda")
    valid = (m >= at) & (m < at + SPARSE_VALID)
    qmask = torch.zeros((batch, F), dtype=torch.bool, device="cuda")
    qmask[torch.arange(batch, device="cuda"),
          torch.randint(0, F, (batch,), generator=g, device="cuda")] = True
    return q, d, valid, qmask


def inputs(batch: int, batches=()):
    """[(label, (q, desc, valid, qmask or None))]: frame 130's searches
    of the mapped main path at `batch` sequences, random descriptors with
    every entry valid, and at each of `batches` random all-valid and
    sparse ones."""
    import chip_smoke as cs
    from ..runner import run_batch_mapped
    cfg = cs.mapped_config()
    stream = cs.mapped_stream(cfg)
    s, ms, fib, _ = cs.make_mapped_run(cfg, torch, "cuda", batch, stream,
                                       frames=cs.MAP_CAPTURE_FRAME + 1)
    a = cs.MAP_CAPTURE_FRAME
    s, ms, _, _ = run_batch_mapped(cfg, s, ms, cs.window(fib, 0, a), seed=1)
    with cs.Recorder(torch, hm, ["hamming_nn"]) as seen:
        run_batch_mapped(cfg, s, ms, cs.window(fib, a, a + 1), seed=2)
    torch.cuda.synchronize()
    calls = [tuple(c) + (None,) * (4 - len(c)) for c in seen["hamming_nn"]]
    out = [("retire, masked", calls[0]),
           ("retire, no mask", calls[0][:3] + (None,)),
           ("closure", calls[-1])]
    for B in (batch,) + tuple(batches):
        q, d, v = cs.random_hamming_inputs(torch, B, 20000, 256, seed=256)
        out.append((f"random, all valid, B={B}",
                    (q, d, torch.ones_like(v), None)))
    for B in batches:
        q, d, v, qm = sparse_inputs(B, seed=B)
        out += [(f"sparse, masked, B={B}", (q, d, v, qm)),
                (f"sparse, no mask, B={B}", (q, d, v, None))]
    return out


def differ(a, b, qmask):
    """Largest |difference| of two (dist, idx) results, on the unmasked
    rows."""
    on = torch.ones_like(a[0], dtype=torch.bool) if qmask is None else qmask
    return max(int((x - y)[on].abs().max()) if bool(on.any()) else 0
               for x, y in zip(a, b))


def mapped_runs(par_call, this_call):
    """Phase 11's mapped path (B = 2, 60 frames, fusion on, the same
    draws), with B6 on the other build, this one and this one again;
    returns [(poses, closure rows, map count, fusions)]."""
    import chip_smoke as cs
    from ..map.p3p import N_HYPS
    from ..runner import run_batch_mapped
    cfg = dataclasses.replace(cs.mapped_config(),
                              lc_min_age_frames=cs.MAP_CMP_AGE)
    stream = cs.mapped_stream(cfg)
    g = torch.Generator()
    g.manual_seed(7)
    u = torch.rand((2, cs.MAP_CMP_FRAMES, N_HYPS, cfg.dims.n_features),
                   generator=g, dtype=torch.float32).to("cuda")
    out, orig = [], hm.hamming_nn
    try:
        for call in (par_call, this_call, this_call):
            hm.hamming_nn = call
            s, ms, fib, _ = cs.make_mapped_run(
                cfg, torch, "cuda", 2, stream, frames=cs.MAP_CMP_FRAMES,
                capacity=cs.MAP_CMP_CAPACITY)
            _, ms, o, lcs = run_batch_mapped(cfg, s, ms, fib, uniforms=u)
            out.append((o.Tsb.cpu(), lcs.cpu(), ms.count.cpu(),
                        ms.n_merged.cpu()))
    finally:
        hm.hamming_nn = orig
    return out


def breakdown(batch: int = 64, batches=(), parents=()):
    """{input label: {build: ms}}; "full2" (and each other build's label
    with "2") the second turns, "diff" {other label: the largest
    difference of its outputs from this source's}; "shape" {B: (C, G) at
    F = 256}; "mapped" the mapped runs on the first other
    build."""
    names = [os.path.basename(os.path.normpath(p)) for p in parents]
    with ThreadPoolExecutor(len(BUILDS) + len(parents)) as pool:
        paths = dict(zip(BUILDS, pool.map(build, BUILDS)))
        others = dict(zip(names, pool.map(other_build, parents, names)))
    calls = {b: wrapper(load(p, ARGS)) for b, p in paths.items()}
    calls.update(others)
    res = {"shape": {B: shape(paths["full"], B, 256)
                     for B in (batch,) + tuple(batches)}}
    order = names + list(BUILDS) + ["full2"] + [n + "2" for n in names]
    for label, args in inputs(batch, batches):
        res[label] = {"diff": {}}
        full = calls["full"](*args)
        for n in names:
            res[label]["diff"][n] = differ(full, calls[n](*args), args[3])
        for b in order:
            fn = calls[b[:-1] if b.endswith("2") and b[:-1] in calls else b]
            res[label][b] = device_ms(lambda fn=fn: fn(*args))
        res[label]["unmasked"] = (args[0].shape[0] * args[0].shape[1]
                                  if args[3] is None else int(args[3].sum()))
    if names:
        res["mapped"] = (names[0], mapped_runs(calls[names[0]],
                                               calls["full"]))
    return res


def same(a, b):
    return [bool(torch.equal(x, y)) for x, y in zip(a, b)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--batches", default="2,8,56,128")
    ap.add_argument("--parent", action="append", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hamming_breakdown: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    print(f"hamming_breakdown: card {cs.card_line()}", flush=True)
    t0 = time.time()
    batches = tuple(int(b) for b in args.batches.split(",") if b)
    res = breakdown(args.batch, batches, args.parent)
    runs = res.pop("mapped", None)
    print("hamming_breakdown: clusters at F = 256 (CTAs a cluster x "
          "clusters a sequence): " + ", ".join(
              f"B={B} {c} x {g}" for B, (c, g) in res.pop("shape").items()),
          flush=True)
    mean = {}     # {(input label, build): mean of its two turns}
    for label, times in res.items():
        diff = times.pop("diff")
        rows = times.pop("unmasked")
        full = (times["full"] + times["full2"]) / 2
        mean[label, "this source"] = full
        for b, ms in times.items():
            note = ("" if b in ("full", "full2") or b.rstrip("2") in diff
                    else f" ({'variant' if b in VARIANTS else 'saves'} "
                    f"{full - ms:.4f} ms)")
            print(f"hamming_breakdown: {label} ({rows} unmasked rows) "
                  f"{b:8s} {ms:.4f} ms{note}", flush=True)
        for n, d in diff.items():
            other = mean[label, n] = (times[n] + times[n + "2"]) / 2
            print(f"hamming_breakdown: {label}: this source {full:.4f} ms "
                  f"against {n}'s {other:.4f} ms: {other / full:.2f} x "
                  f"faster; outputs differ by at most {d} on the "
                  f"unmasked rows", flush=True)
    # a mapped frame makes two retirement searches and one closure search
    # (a build without the query-row mask scores every retirement row)
    for n in ["this source"] + [os.path.basename(os.path.normpath(p))
                                for p in args.parent]:
        print(f"hamming_breakdown: a mapped frame's three searches (2 x "
              f"retire, masked + closure), {n}: "
              f"{2 * mean['retire, masked', n] + mean['closure', n]:.4f} ms",
              flush=True)
    if runs:
        name, runs = runs
        names = ("poses", "closure rows", "map count", "fusions")
        for tag, (a, b) in ((f"{name}'s B6 vs this one", runs[:2]),
                            ("this B6 vs itself", runs[1:])):
            eq = same(a, b)
            print(f"hamming_breakdown: mapped path (B=2, 60 frames, fusion "
                  f"on), {tag}: " + ", ".join(
                      f"{n} {'identical' if e else 'DIFFER'}"
                      for n, e in zip(names, eq))
                  + f"; closure rows {int(a[1].sum())} and "
                  f"{int(b[1].sum())}, map count {a[2].tolist()} and "
                  f"{b[2].tolist()}, fusions {a[3].tolist()} and "
                  f"{b[3].tolist()}", flush=True)
    print(f"hamming_breakdown: {time.time() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
