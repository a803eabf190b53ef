"""Where the LK Gauss-Newton kernel's (B5) time goes, level by level, and
how it compares with another tree's build of it, on the card.

Builds ``csrc/lk.cu`` as it is, with one step of B5 (or all three) cut
out of the source, as an empty kernel on the same grid, and with other
launch shapes, and times each build through a wrapper like
``ops/lk.gn_tracks`` on the same inputs. A cut build computes a wrong
result; its time says how much the step costs where it stands, overlap
included: the saving is the full kernel's time less the cut one's.

    python -m xivo_tpu_torch.tools.lk_breakdown [--parent DIR]

Run it from the repository root: the inputs are ``chip_smoke.py`` phase
6's. Every B5 call of the first IMG_CAPTURE_FRAMES frames of the image
main path (B = 16 sequences, 2048 tracks a launch, one launch a pyramid
level, coarse to fine) and of one LK call on random textures; the builds
are timed on each level of the last recorded frame and of the random
call, and compared with DIR's on every call.

Steps:
- ``load``: the search patch's cp.async copies (the patch is filled with
  zeros instead);
- ``regs``: the loads of T, Gx and Gy into registers (zeros instead);
- ``iterate``: the Gauss-Newton loop (what was loaded is still read
  once, so that no load is dropped with it);
- ``all``: the three together (what is left: launch, the state's load,
  the scalars, the writes);
- ``empty``: a kernel that returns at once, on the same grid: the floor
  of a launch.
With ``load`` or ``regs`` cut the loop runs on zeros, and tracks then
stop after a step or two: their saving includes the iterations. The
loads alone are ``iterate`` less ``all``.

Variants: ``warps2`` and ``warps4`` (two or four tracks a block, a warp
each, neighbouring tracks in one block), ``strided4`` (four a block, the
tracks of a block a grid apart), ``padded`` (the patch's rows ld = S + ((w
- S) mod 32) floats apart in shared memory, which puts lane e's entry in
bank e mod 32, in place of S, where two lanes share a bank on every tap)
and ``idiv`` (the window entries' patch offsets from an integer division
in place of a float product). For each level the tool prints how many
blocks of 1, 2 and 4 tracks hold a live track.

``--parent DIR`` (repeatable): DIR is another checkout of the repository
(a commit unpacked with ``git archive``); its ``csrc/lk.cu`` is built
too and timed in turns on the same inputs: each other build, this
source, the cuts and variants, this source again, each other build
again. The largest difference of positions and flags from this source's
output is printed, over every input.

For each level the tool also prints the longest chain (the most
iterations any track ran) and the iterations in all, from the plain
version run a step at a time, and a frame's four-launch sum per build.
Times are ms per launch from CUDA events, the card held by a sleep
kernel while the host enqueues (as ``chip_smoke.py`` times every kernel).
Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from ..ops import _build
from ..ops import lk as lko
from .chol_breakdown import device_ms, nvcc

SOURCE = os.path.join(_build.CSRC, "lk.cu")
OUT_DIR = os.path.join(_build.BUILD_DIR, "lk_breakdown")

# each step's code, replaced exactly as it stands: (old, new)
_LOOP = "        for (int it = 0; it < iters && !done; ++it) {\n"
_COPY = "            cp_async4(patch + e, src + e);\n"
CUTS = {
    "load": [(_COPY, "            patch[e] = 0.0f;\n")],
    "regs": [("            t_[k] = on ? T[base + e] : 0.0f;\n"
              "            gx_[k] = on ? Gx[base + e] : 0.0f;\n"
              "            gy_[k] = on ? Gy[base + e] : 0.0f;\n",
              "            t_[k] = gx_[k] = gy_[k] = 0.0f;\n")],
    "iterate": [(_LOOP,
                 "        float keep = gxx + gxy + gyy + det + lox + loy + "
                 "hix + hiy + eps2;\n"
                 "#pragma unroll\n"
                 "        for (int k = 0; k < kMaxPerLane; ++k)\n"
                 "            keep += t_[k] + gx_[k] + gy_[k] + patch[ij_[k]];"
                 "\n        if (keep == 1.2345e-30f) esc = true;\n"
                 "        for (int it = 0; it < 0 && !done; ++it) {\n")],
}
_EMPTY = [("          float inv_w, int iters) {\n",
           "          float inv_w, int iters) {\n    return;\n")]
_WARPS = "constexpr int kWarps = 1;"
VARIANTS = {
    "warps2": [(_WARPS, "constexpr int kWarps = 2;")],
    "warps4": [(_WARPS, "constexpr int kWarps = 4;")],
    "strided4": [(_WARPS, "constexpr int kWarps = 4;"),
                 ("    const int track = blockIdx.x * kWarps + warp;\n",
                  "    const int track = blockIdx.x + warp * gridDim.x;\n")],
    "padded": [("    const int ld = S;    // the patch's row stride in shared "
                "memory\n",
                "    const int ld = S + ((w - S) % 32 + 32) % 32;\n"),
               ("        for (int e = lane; e < S * S; e += 32)\n" + _COPY,
                "        const float inv_s = 1.0f / S;\n"
                "        for (int e = lane; e < S * S; e += 32)\n"
                "            cp_async4(patch + e + (int)(((float)e + 0.5f) * "
                "inv_s) * (ld - S), src + e);\n")],
    "idiv": [("            ij_[k] = e < n ? e + i * (ld - w) : 0;\n",
              "            ij_[k] = e < n ? (e / w) * ld + e % w : 0;\n")],
}
BUILDS = ("full",) + tuple(CUTS) + ("all", "empty") + tuple(VARIANTS)
ENTRY = "xivo_lk_gn_f32"
ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def variant_source(name: str) -> str:
    with open(SOURCE) as f:
        src = f.read()
    if name == "full":
        return src
    subs = (sum(CUTS.values(), []) if name == "all" else _EMPTY
            if name == "empty" else CUTS.get(name) or VARIANTS[name])
    for old, new in subs:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the kernel no longer has {old!r} "
                               f"once; update CUTS")
        src = src.replace(old, new)
    return src


def build(name: str) -> str:
    os.makedirs(OUT_DIR, exist_ok=True)
    src = os.path.join(OUT_DIR, f"{name}.cu")
    with open(src, "w") as f:
        f.write(variant_source(name))
    return nvcc(src, os.path.join(OUT_DIR, f"lib{name}.so"))


def other_build(tree: str, name: str) -> str:
    os.makedirs(OUT_DIR, exist_ok=True)
    return nvcc(os.path.join(tree, "xivo_tpu_torch", "csrc", "lk.cu"),
                os.path.join(OUT_DIR, f"lib_{name}.so"))


def wrapper(path: str):
    """``ops/lk.gn_tracks``'s launch on a given build (no checks)."""
    fn = getattr(ctypes.CDLL(path), ENTRY)
    fn.argtypes, fn.restype = ARGS, ctypes.c_int

    def call(sp, T, Gx, Gy, sc, pt, st, iters):
        pt_out, st_out = torch.empty_like(pt), torch.empty_like(st)
        if fn(*(x.data_ptr() for x in (sp, T, Gx, Gy, sc, pt, st, pt_out,
                                       st_out)),
              pt.numel() // 2, sp.shape[-1], T.shape[-1], iters,
              _build.stream(sp)) != 0:
            raise RuntimeError(f"{path}: launch failed")
        return pt_out, st_out
    return call


def chain_lengths(args):
    """Iterations each track runs: the plain loop a step at a time (its
    state is (pt, st)), counting the tracks not yet done before each
    step. The largest is the longest chain, the sum the iterations in
    all (what ``chip_smoke.py`` counts for B5's bound)."""
    sp, T, Gx, Gy, sc, pt, st, iters = args
    n = torch.zeros(st.shape[:-1], dtype=torch.int64, device=st.device)
    for _ in range(iters):
        n += st[..., 0] < 0.5
        pt, st = lko.gn_tracks_plain(sp, T, Gx, Gy, sc, pt, st, 1)
    return n


def live_blocks(st, warps: int) -> int:
    """Blocks of `warps` tracks that hold at least one live track."""
    live = (st[..., 0] < 0.5).reshape(-1).to(torch.int32)
    live = torch.nn.functional.pad(live, (0, (-live.numel()) % warps))
    return int(live.reshape(-1, warps).any(dim=1).sum())


def inputs():
    """(recorded, random, levels): the B5 calls of phase 6's recorded
    frames and of its LK call on random textures, each a list of
    argument tuples in call order (coarse to fine, `levels` a frame)."""
    import chip_smoke as cs
    from ..runner import run_batch_image
    from ..sim.image_stream import build_image_stream
    cfg = cs.image_config()
    stream = build_image_stream(cfg)
    with cs.Recorder(torch, lko, ["gn_tracks"]) as seen:
        s, f, fib = cs.make_image_run(cfg, torch, "cuda", cs.IMG_B, stream,
                                      frames=cs.IMG_CAPTURE_FRAMES)
        run_batch_image(cfg, s, f, fib)
        torch.cuda.synchronize()
    rnd = cs.texture_lk_inputs(torch, lko, cfg, cs.IMG_B, cfg.dims.nf_rows)
    return seen["gn_tracks"], rnd["gn_tracks"], cfg.klt_max_level


def differ(a, b):
    """(largest |position difference|, tracks whose flags differ)."""
    return (float((a[0] - b[0]).abs().max()),
            int((a[1] != b[1]).any(dim=-1).sum()))


def breakdown(parents=()):
    """{"levels": {(input, level): {build: ms, "chain": (longest, all),
    "live": n, "tracks": M, "blocks": {warps: n}}}, "diff": {other:
    (position, flags)}}; "full2" (and each other build's name with "2")
    the second turns."""
    names = [os.path.basename(os.path.normpath(p)) for p in parents]
    with ThreadPoolExecutor(len(BUILDS) + len(names)) as pool:
        paths = dict(zip(BUILDS, pool.map(build, BUILDS)))
        paths.update(zip(names, pool.map(other_build, parents, names)))
    calls = {b: wrapper(p) for b, p in paths.items()}
    recorded, rnd, L = inputs()
    res = {"levels": {}, "diff": {}}
    for n in names:
        worst = (0.0, 0)
        for args in recorded + rnd:
            d = differ(calls["full"](*args), calls[n](*args))
            worst = (max(worst[0], d[0]), worst[1] + d[1])
        res["diff"][n] = worst
    order = names + list(BUILDS) + ["full2"] + [n + "2" for n in names]
    for label, group in (("recorded", recorded[-L:]), ("random", rnd[-L:])):
        for i, args in enumerate(group):
            st = args[6]
            n = chain_lengths(args)
            row = {"chain": (int(n.max()), int(n.sum())),
                   "live": int((st[..., 0] < 0.5).sum()),
                   "tracks": st.numel() // 2,
                   "blocks": {w: live_blocks(st, w) for w in (1, 2, 4)}}
            for b in order:
                fn = calls[b[:-1] if b.endswith("2") and b[:-1] in calls
                           else b]
                row[b] = device_ms(lambda fn=fn: fn(*args))
            res["levels"][label, L - 1 - i] = row
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", action="append", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lk_breakdown: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    print(f"lk_breakdown: card {cs.card_line()}", flush=True)
    t0 = time.time()
    res = breakdown(args.parent)
    names = list(res["diff"])
    frame = {}      # {(input, build): a frame's four launches, ms}
    for (label, lvl), row in res["levels"].items():
        chain, live, M = row.pop("chain"), row.pop("live"), row.pop("tracks")
        blocks = row.pop("blocks")
        full = (row["full"] + row["full2"]) / 2
        head = f"lk_breakdown: {label} level {lvl} ({M} tracks, {live} live)"
        print(f"{head}: longest chain {chain[0]} iterations, {chain[1]} in "
              f"all; blocks with a live track: " + ", ".join(
                  f"{w} warp{'s' if w > 1 else ''} a block {n} of "
                  f"{-(-M // w)}" for w, n in blocks.items()), flush=True)
        for b, ms in row.items():
            note = ("" if b in ("full", "full2") or b.rstrip("2") in names
                    else f" ({'variant' if b in VARIANTS else 'saves'} "
                    f"{full - ms:+.4f} ms)")
            print(f"{head} {b:9s} {ms:.4f} ms{note}", flush=True)
        mean = {"this source": full}
        mean.update({b: (row[b] + row[b + "2"]) / 2 for b in names})
        mean.update({b: row[b] for b in BUILDS if b != "full"})
        for b, ms in mean.items():
            frame[label, b] = frame.get((label, b), 0.0) + ms
        for n in names:
            print(f"{head}: this source {full:.4f} ms against {n}'s "
                  f"{mean[n]:.4f} ms: {mean[n] / full:.3f} x faster",
                  flush=True)
    for (label, b), ms in frame.items():
        print(f"lk_breakdown: {label}, a frame's four launches, {b}: "
              f"{ms:.4f} ms", flush=True)
    for n, (dpos, dflags) in res["diff"].items():
        print(f"lk_breakdown: this source against {n}, every recorded and "
              f"random call: positions differ by at most {dpos:g} px, "
              f"flags on {dflags} tracks", flush=True)
    print(f"lk_breakdown: {time.time() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
