"""The sweep that sets a configuration's batch B: for each B, a cell of
the workload at that B, a few warm frames, then the device's busy share
over a traced span of frame steps (the profiler, the device alone), the
mean step over the same number of unprofiled steps (CUDA events) and the
peak memory. From the root of a checkout, on the card:

    python3 portbench/sweep.py --workload pcw_sqrt.montecarlo \\
        --batches 1024,2048,4096,8192 --seed 1

The rule the benchmark takes B by: the smallest B at which the device is
busy for at least half of the traced span with the peak within half the
card's memory; where none is, the busiest B within that memory.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def measure(torch, harness, trace, workload, B, seed, warm, n):
    from torch.profiler import ProfilerActivity, profile
    import importlib
    _, spec, traffic, _ = harness.cell_files(workload)
    entry = importlib.import_module(f"portbench.entries.{spec['entry']}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cell = entry.Cell(spec, traffic, seed, "cuda", batch=B)
    carry = cell.fresh()
    t = 0
    for _ in range(warm):
        carry, _ = cell.step(carry, t)
        t += 1
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            carry, _ = cell.step(carry, t)
            t += 1
        torch.cuda.synchronize()
    ev = trace.raw_device_events(prof)
    del prof
    span = (ev[-1][1] - ev[0][0]) / 1e9 if ev else 0.0
    busy = trace.busy_ns(ev) / 1e9
    clock = harness.Clock("cuda")
    clock.mark()
    for _ in range(n):
        carry, _ = cell.step(carry, t)
        t += 1
        clock.mark()
    torch.cuda.synchronize()
    steps = clock.steps_ms()
    peak = torch.cuda.max_memory_allocated()
    del carry, cell
    torch.cuda.empty_cache()
    return dict(batch=B, busy_share=busy / span if span else None,
                busy_ms_a_step=busy * 1e3 / n, span_ms_a_step=span * 1e3 / n,
                step_ms=sum(steps) / len(steps), step_ms_max=max(steps),
                launches_a_step=len(ev) / n,
                seq_frames_per_s=B * 1e3 * len(steps) / sum(steps),
                peak_gib=peak / 2 ** 30, setup_s=setup)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--batches", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--warm", type=int, default=30)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    from portbench import harness, trace
    rows = []
    for B in (int(b) for b in args.batches.split(",")):
        try:
            r = measure(torch, harness, trace, args.workload, B, args.seed,
                        args.warm, args.steps)
        except torch.cuda.OutOfMemoryError as e:
            r = dict(batch=B, error=f"out of memory: {str(e)[:200]}")
            torch.cuda.empty_cache()
        rows.append(r)
        print(f"sweep {args.workload}: " + json.dumps(r), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(workload=args.workload,
                           card=torch.cuda.get_device_name(0), rows=rows), f)


if __name__ == "__main__":
    main()
