"""Where a cell's device idles, by the program's own spans
(``xivo_tpu_torch.tracing``), and whether those spans lie on the
profiler's clock. From the root of a checkout, on the card:

    python3 portbench/span_report.py --workload pcw_sqrt.imu200 \\
        --seed 7 --out spans_imu200.json

It builds the cell as a ``--trace 1`` run does (tracing on), warms up,
then:

1. runs one job of ``--frames`` frame steps with the device alone under
   the profiler and a CUDA event at each frame end: the idle time by the
   innermost span the host was in (``metrics/_spans.idle_by_leaf``), the
   longest gaps with that span, and each slow frame (step above twice the
   median) with its stages' host ms, its collections and the caching
   allocator's counts;
2. runs the traced run's three passes (``harness.traced_passes``) and
   reads the four span metrics, the synchronized stage times and the
   idle time by innermost span of the device pass;
3. runs the host pass again (the benchmark's ``record_function`` ranges
   around ``propagate_frame`` and ``update_step``, the profiler on host
   and device) and reports how far inside its range each ``propagate``
   and ``update`` span lies (the least margin at either end, ns;
   negative: outside), and the pass's longest device gaps with the span
   the host was in, as step 1 does, its collections and its frames'
   allocator counts.

Prints one JSON object (also written to ``--out``).
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import sys
import time
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SPAN_METRICS = ("propagate_issue_ms", "update_issue_ms",
                "idle_in_propagate_pct", "gc_ms_per_step")
STAGE_SPANS = {"propagate": "propagate", "pointcloud_tracker": "tracker",
               "update": "update"}


def ms(ns):
    return ns / 1e6


def by_leaf(sp, ctx):
    got = sp.idle_by_leaf(ctx)
    if got is None:
        return None
    return {k: ms(v) for k, v in sorted(got.items(), key=lambda kv: -kv[1])}


def longest_gaps(sp, events, spans, top=10):
    """The `top` longest device gaps, each with the host's innermost span
    over most of it."""
    pieces = sp.leaf_pieces(spans)
    gaps = sorted(sp.idle_gaps(events), key=lambda g: g[0] - g[1])[:top]
    out = []
    for s, e in gaps:
        share = {}
        for j, ns in sp.overlaps([(s, e)], pieces):
            share[pieces[j][2]] = share.get(pieces[j][2], 0) + ns
        where = max(share, key=share.get) if share else sp.BETWEEN
        out.append([round(ms(e - s), 3), where])
    return out


def frame_rows(spans, frames):
    """{frame: {stage or gc: host ms, allocator counts}} of `frames`."""
    rows = {f.frame: {"host_ms": ms(f.end_ns - f.start_ns),
                      **(f.info or {})} for f in frames}
    for r in spans:
        row = rows.get(r.frame)
        if row is None or r.name == "frame":
            continue
        if r.name == "gc":
            row.setdefault("gc", []).append(
                [round(ms(r.end_ns - r.start_ns), 3),
                 r.info["generation"], r.info["collected"]])
        elif r.name in STAGE_SPANS.values():
            row[r.name] = row.get(r.name, 0.0) + ms(r.end_ns - r.start_ns)
    return rows


def activities(device, host=False):
    """The profiler's activities: the device's, with the host's too if
    `host` (the CPU's alone where the device is the CPU)."""
    from torch.profiler import ProfilerActivity
    if device == "cpu":
        return [ProfilerActivity.CPU]
    return [ProfilerActivity.CPU] * host + [ProfilerActivity.CUDA]


def job_pass(harness, trace, sp, cell, n, device):
    """Step 1: one job under the device-only profiler."""
    from torch.profiler import profile
    carry, clock = cell.fresh(), harness.Clock(device)
    harness.synchronize(device)
    sp.tracing.clear()
    with profile(activities=activities(device)) as prof:
        clock.mark()
        for t in range(n):
            carry, _ = cell.step(carry, t)
            clock.mark()
        harness.synchronize(device)
    ev = trace.raw_device_events(prof)
    del prof, carry
    spans = sp.tracing.records()
    ctx = dict(device_events=ev, device_frames=n)
    steps = clock.steps_ms()
    med = statistics.median(steps)
    sel = sp.device_pass(ctx)
    win = sp.device_window(ctx)
    out = dict(frames=n, launches_per_step=len(ev) / n,
               idle_pct=(100.0 * (1 - trace.busy_ns(ev) / (win[1] - win[0]))
                         if win else None),
               step_ms_median=med, step_ms_max=max(steps),
               idle_by_leaf_ms=by_leaf(sp, ctx))
    if sel is not None:
        frames, inside = sel
        out["longest_gaps_ms"] = longest_gaps(sp, ev, frames + inside)
        rows = frame_rows(inside, frames)
        slow = [i for i, s in enumerate(steps) if s > 2 * med]
        order = sorted(rows)
        out["slow_frames"] = [dict(index=i, step_ms=steps[i],
                                   **rows[order[i]]) for i in slow]
        out["frame_median"] = {
            k: statistics.median(r.get(k, 0.0) for r in rows.values())
            for k in ("host_ms", *STAGE_SPANS.values(), "device_allocs",
                      "alloc_retries")}
        out["gc_in_job"] = [g for r in rows.values() for g in r.get("gc",
                                                                    [])]
    return out


def host_pass(torch, harness, trace, sp, cell, stages, t0, device, n=3):
    """Step 3: the host pass again; each program span against the
    benchmark's range around the same call, and the pass's longest
    gaps."""
    from torch.profiler import profile
    paths = {stages["propagate"]: "propagate", stages["update"]: "update"}
    carry = cell.fresh()
    for t in range(t0):
        carry, _ = cell.step(carry, t)
    harness.synchronize(device)
    sp.tracing.clear()
    with trace.Ranges(torch, list(paths)):
        with profile(activities=activities(device, host=True)) as prof:
            for t in range(t0, t0 + n):
                carry, _ = cell.step(carry, t)
            harness.synchronize(device)
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation() and e.name() in paths \
                and "CUDA" not in str(e.device_type()):
            ranges.setdefault(paths[e.name()], []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    ev = trace.raw_device_events(prof)
    del prof
    spans = sp.tracing.records()
    frames = [r for r in spans if r.name == "frame"]
    out = dict(longest_gaps_ms=longest_gaps(sp, ev, spans),
               gc=[[round(ms(r.end_ns - r.start_ns), 3),
                    r.info["generation"], r.info["collected"]]
                   for r in spans if r.name == "gc"],
               frames=[r.info for r in frames])
    for name in paths.values():
        mine = sorted((r.start_ns, r.end_ns) for r in spans
                      if r.name == name)
        theirs = sorted(ranges.get(name, []))
        if len(mine) != len(theirs) or not mine:
            out[name] = dict(spans=len(mine), ranges=len(theirs))
            continue
        margins = [min(s - rs, re_ - e)
                   for (s, e), (rs, re_) in zip(mine, theirs)]
        out[name] = dict(spans=len(mine), least_margin_ns=min(margins),
                         largest_margin_ns=max(max(s - rs, re_ - e)
                                               for (s, e), (rs, re_)
                                               in zip(mine, theirs)),
                         all_inside=min(margins) >= 0)
    return out


def traced_passes(harness, sp, cell, traffic, entry, device):
    """Step 2: the traced run's passes, as the harness makes them."""
    metrics = [importlib.import_module(f"portbench.metrics.{m}")
               for m in SPAN_METRICS + ("propagate_sync_ms",
                                        "update_sync_ms")]
    tracker_role = SimpleNamespace(ROLE="pointcloud_tracker")
    sp.tracing.clear()
    ctx = harness.traced_passes(cell, traffic, metrics + [tracker_role],
                                entry, device)
    harness.synchronize(device)
    out = dict(metrics={m.__name__.rsplit(".", 1)[1]: m.read(ctx)
                        for m in metrics})
    dp = out["traced_device_pass"] = dict(idle_by_leaf_ms=by_leaf(sp, ctx))
    sel = sp.device_pass(ctx)
    if sel is not None:
        n = ctx["device_frames"]
        dp["issue_ms"] = {k: sum(r.end_ns - r.start_ns for r in sel[1]
                                 if r.name == k) / 1e6 / n
                          for k in STAGE_SPANS.values()}
        dp["sync_ms"] = {span: ctx["sync"][ctx["stages"][role]] * 1e3
                         / ctx["sync_frames"]
                         for role, span in STAGE_SPANS.items()
                         if ctx["stages"].get(role) in ctx["sync"]}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--frames", type=int, default=None,
                    help="frames of step 1's job (default: the job's T)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cpu rehearses the run (no device events)")
    ap.add_argument("--batch", type=int, default=None,
                    help="B (default: the configuration's)")
    args = ap.parse_args(argv)
    dev = args.device

    import torch
    from portbench import harness, trace
    from portbench.metrics import _spans as sp
    if sp.tracing is None:
        print("span_report: the program has no tracing module",
              file=sys.stderr)
        return 1
    sp.tracing.enable()
    w, spec, traffic, _ = harness.cell_files(args.workload)
    entry = importlib.import_module(f"portbench.entries.{spec['entry']}")
    cell = entry.Cell(spec, traffic, args.seed, dev, batch=args.batch)
    carry = cell.fresh()
    for t in range(min(traffic["warm_frames"], cell.T)):
        carry, _ = cell.step(carry, t)
    carry, _ = cell.step(cell.fresh(), 0)
    del carry
    harness.synchronize(dev)
    out = dict(workload=args.workload, seed=args.seed, B=cell.B,
               device=harness.device_line(dev, w["chips"]))
    t0 = time.perf_counter()
    out["job"] = job_pass(harness, trace, sp, cell, args.frames or cell.T,
                          dev)
    out["job"]["seconds"] = time.perf_counter() - t0

    if dev != "cpu":        # the harness's passes profile and sync CUDA
        out.update(traced_passes(harness, sp, cell, traffic, entry, dev))
    out["host_pass"] = host_pass(torch, harness, trace, sp, cell,
                                 entry.STAGES, traffic["warm_frames"], dev)
    text = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
