"""One run of one cell: set-up, warm-up, the measured window, the traced
passes, the output check and the result.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by name: ``configs/<config>.json``,
``traffic/<cell>.json``, ``entries/<entry>.py`` (the program's side of
an entry), ``refs/<entry>.py`` (the plain reference's side) and
``metrics/<metric>.py``. ``run_cell`` takes a device, sizes and a fault
to plant for the benchmark's own tests; the command line (``run.py``)
always runs on the card, at the sizes in the files.
"""
from __future__ import annotations

import importlib
import json
import math
import os
import sys
import time

import numpy as np
import torch

from . import trace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_files(workload: str):
    """(benchmark entry of the cell, configuration, traffic, per-layer
    metric entries reported in the cell)."""
    bench = load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"portbench: no workload {workload!r} in "
                         f"BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    spec = load_json(ROOT, conf["file"])
    traffic = load_json(HERE, "traffic", f"{workload}.json")
    e2e = {m["name"] for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])}
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload])
                 and m["moves"] in e2e]
    return w, spec, traffic, per_layer


def synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Clock:
    """Frame boundaries: CUDA events on the card, recorded without a host
    sync and read after the window; host times on the CPU (the
    benchmark's own tests)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def steps_ms(self):
        """The times between consecutive marks, ms."""
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(self.marks,
                                                      self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def run_window(cell, seconds, device, fault=None, n_frames=None):
    """Jobs back to back until the host clock passes `seconds` (or, for
    the benchmark's own tests, `n_frames` frames have run), the last one
    cut at the frame where it does. Returns (wall s, step times ms, [per
    job: [StepOutputs (B, 1, ...) a frame]])."""
    step = cell.step if fault is None else fault(cell)
    clock = Clock(device)
    jobs = []
    synchronize(device)
    clock.mark()
    t0 = time.perf_counter()
    done, n = False, 0
    while not done:
        carry, outs = cell.fresh(), []
        jobs.append(outs)
        for t in range(cell.T):
            carry, out = step(carry, t)
            outs.append(out)
            clock.mark()
            n += 1
            if (n >= n_frames if n_frames else
                    time.perf_counter() - t0 >= seconds):
                done = True
                break
    synchronize(device)
    wall = time.perf_counter() - t0
    return wall, clock.steps_ms(), jobs


def job_outputs(outs, fields):
    """{field: (B, t, ...)} of one job's per-frame outputs."""
    return {f: torch.cat([getattr(o, f) for o in outs], 1) for f in fields}


def step_p95(steps):
    """The 95th percentile of every step of the window (ms)."""
    return float(np.percentile(np.asarray(steps), 95))


def e2e_metrics(cell, wall, steps, jobs):
    """The end-to-end numbers of a window, and (attempted, failed). The
    trajectory error is taken over the sequences the window finished:
    every row and frame of each whole job (all the window's frames where
    none finished), since the error grows along a sequence and where the
    window cuts the last job would otherwise move it."""
    n_frames = sum(len(j) for j in jobs)
    whole = [j for j in jobs if len(j) == cell.T] or jobs
    sq, count, failed = 0.0, 0, 0
    for outs in jobs:
        Tsb = job_outputs(outs, ("Tsb",))["Tsb"].double()
        fin = torch.isfinite(Tsb).all(dim=-1).all(dim=-1)
        failed += int((~fin).sum())
        if any(outs is j for j in whole):
            gt = cell.gt_Tsb[:, :Tsb.shape[1]]
            err = ((Tsb - gt) ** 2).sum(-1)[fin]
            sq += float(err.sum())
            count += err.numel()
    return {
        "seq_frames_per_s": cell.B * n_frames / wall,
        "step_ms_p95": step_p95(steps),
        "ate_rmse_m": math.sqrt(sq / count) if count else float("nan"),
    }, cell.B * len(jobs), failed


def traced_passes(cell, traffic, metrics, entry_mod, device):
    """The traced run's three passes over one job, after `warm` frames:
    the device alone under the profiler, the host's ranges under the
    profiler, then each stage synchronized. Returns the context the
    per-layer metrics read."""
    from torch.profiler import ProfilerActivity, profile
    tr = traffic["trace"]
    warm, n_dev, n_host, n_sync = (tr["warm_frames"], tr["device_frames"],
                                   tr["host_frames"], tr["sync_frames"])
    if warm + n_dev + n_host + n_sync > cell.T:
        raise ValueError("the traced passes need more frames than a job")
    stages = entry_mod.STAGES
    ranges, keep, timed = list(stages.values()), [], []
    for m in metrics:
        ranges += getattr(m, "RANGES", [])
        keep += getattr(m, "KEEP_ARGS", [])
        if getattr(m, "ROLE", None) in stages:
            timed.append(stages[m.ROLE])
    ranges = list(dict.fromkeys(ranges))
    carry, t = cell.fresh(), 0
    for _ in range(warm):
        carry, _ = cell.step(carry, t)
        t += 1
    synchronize(device)

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n_dev):
            carry, _ = cell.step(carry, t)
            t += 1
        synchronize(device)
    dev_events = trace.raw_device_events(prof)
    del prof

    with trace.Ranges(torch, ranges, keep=keep) as rg:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n_host):
                carry, _ = cell.step(carry, t)
                t += 1
            synchronize(device)
    host, tagged = trace.attribute(prof, ranges)
    del prof
    print("portbench: traced ranges with device work (calls, spans): "
          + ", ".join(f"{p.split(':')[1]} {len(rg.args[p])} {len(host[p])}"
                      for p in ranges), file=sys.stderr, flush=True)

    with trace.Timed(torch, timed) as tm:
        for _ in range(n_sync):
            carry, _ = cell.step(carry, t)
            t += 1
    return dict(stages=stages, device_events=dev_events,
                device_frames=n_dev, host=host, host_args=rg.args,
                host_frames=n_host, host_events=tagged, sync=tm.total,
                sync_calls=tm.calls, sync_frames=n_sync)


def breakdown(ctx, top=10):
    """The device operations that took most time in the device pass, and
    the longest idle gaps of the host pass, each named by the innermost
    range whose device span holds the work that ended the gap."""
    by_name = {}
    for s, e, name, _ in ctx["device_events"]:
        by_name[name] = by_name.get(name, 0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps, last_end = [], None
    for s, e, name, rng in ctx["host_events"]:
        if last_end is not None and s > last_end:
            where = rng.split(":")[-1] if rng else "outside the ranges"
            gaps.append((s - last_end, where))
        last_end = e if last_end is None else max(last_end, e)
    gaps.sort(key=lambda g: -g[0])
    return {"device_ops": [[n[:120], ns / 1e9] for n, ns in ops],
            "idle_gaps": [[w, ns / 1e9] for ns, w in gaps[:top]]}


def device_line(device, chips):
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def sampled(cell, traffic, jobs, seed):
    """What the output check compares: the compared outputs of the rows
    drawn from `seed`, for every job of the window ([{field: (R, t, ...)
    on the CPU}]), and those rows' inputs as the reference takes them."""
    from .entries.common import check_rows
    from .refs import common as refc
    ck = traffic["check"]
    rows = torch.from_numpy(check_rows(seed, cell.B, ck["rows"]))
    got = []
    for outs in jobs:
        o = job_outputs(outs, refc.COMPARED)
        got.append({k: v.index_select(0, rows.to(v.device)).cpu()
                    for k, v in o.items()})
    return got, cell.rows(rows)


def row_gaps(got, want):
    """(R,) each sampled row's widest position gap (m) and widest
    rotation-matrix entry gap over every frame of every job of the
    window; a row whose pose left the finite numbers reads 1e30."""
    pos = rot = None
    for g in got:
        t = g["Tsb"].shape[1]
        dp = (g["Tsb"].double() - want["Tsb"][:, :t].double()).norm(dim=-1)
        dr = (g["Rsb"].double() - want["Rsb"][:, :t].double()).abs()
        dp = torch.nan_to_num(dp.amax(-1), nan=1e30, posinf=1e30)
        dr = torch.nan_to_num(dr.flatten(2).amax(-1).amax(-1), nan=1e30,
                              posinf=1e30)
        pos = dp if pos is None else torch.maximum(pos, dp)
        rot = dr if rot is None else torch.maximum(rot, dr)
    return pos, rot


def quantiles(x):
    q = torch.quantile(x, torch.tensor([0.0, 0.5, 0.9, 1.0], dtype=x.dtype))
    return [float(f"{v:.3e}") for v in q]


def compare(got, want, check):
    """The compared number over every job of the window:
    ``rows_off_pct``, the share (%) of the sampled rows whose widest
    position gap (m) is above ``check["row_limits"]["pos_m"]`` or whose
    widest rotation-matrix entry gap is above ``["rot"]``
    (``row_gaps``). A widest gap over all rows is no steady number:
    float32 rounding sends one to four rows in a hundred millimetres to
    centimetres off the float64 reference through a decision that flips
    (a feature's gate; the reference itself in float32 does the same),
    while the other rows stay within ~4e-5 m; so the share of such rows
    is held to ``check["limits"]["rows_off_pct"]``.
    Returns ({number: (value, limit)}, all within, the rows' gaps)."""
    pos, rot = row_gaps(got, want)
    r = check["row_limits"]
    off = (pos > r["pos_m"]) | (rot > r["rot"])
    vals = {"rows_off_pct": 100.0 * float(off.sum()) / off.numel()}
    limits = check["limits"]
    ok = all(vals[k] <= limits[k] for k in vals)
    return {k: (v, limits[k]) for k, v in vals.items()}, ok, (pos, rot)


def run_cell(workload, seed, seconds, trace_on, device="cuda",
             t_start=None, batch=None, frames=None, fault=None,
             window_frames=None, log=sys.stderr):
    """One run; returns the result line's object. `batch`, `frames`,
    `fault` (a function of the cell returning a broken frame step) and
    `window_frames` (a window of so many frames) are for the benchmark's
    own tests."""
    t_start = time.perf_counter() if t_start is None else t_start
    w, spec, traffic, per_layer = cell_files(workload)
    entry = importlib.import_module(f"portbench.entries.{spec['entry']}")
    ref = importlib.import_module(f"portbench.refs.{spec['entry']}")
    metrics = [importlib.import_module(f"portbench.metrics.{m['name']}")
               for m in per_layer] if trace_on else []
    t_cell = time.perf_counter()
    cell = entry.Cell(spec, traffic, seed, device, batch=batch,
                      frames=frames)
    synchronize(device)
    t_warm = time.perf_counter()

    # warm-up: the first frames of a job, which every shape of the
    # window passes through, and a second job's first frame
    carry = cell.fresh()
    for t in range(min(traffic["warm_frames"], cell.T)):
        carry, _ = cell.step(carry, t)
    carry, _ = cell.step(cell.fresh(), 0)
    del carry
    synchronize(device)
    t_end = time.perf_counter()
    setup_s = t_end - t_start
    print(f"portbench: set-up {setup_s:.2f} s: start to the cell "
          f"{t_cell - t_start:.2f} s, the cell's inputs "
          f"{t_warm - t_cell:.2f} s, warm-up {t_end - t_warm:.2f} s "
          f"({traffic['warm_frames']} + 1 frames)", file=log, flush=True)

    wall, steps, jobs = run_window(cell, seconds, device, fault,
                                   window_frames)
    metrics_e2e, attempted, failed = e2e_metrics(cell, wall, steps, jobs)
    dev = device_line(device, w["chips"])
    firsts, n = [], 0
    for j in jobs:
        firsts.append(round(steps[n], 2))
        n += len(j)
    print(f"portbench: {workload} B={cell.B} T={cell.T} jobs {len(jobs)} "
          f"frames {n} wall {wall:.3f} s setup {setup_s:.2f} s; peak "
          f"memory {dev['memory_peak_bytes'] / 2 ** 30:.2f} GiB; steps ms: "
          f"median {np.median(steps):.2f}, each job's first {firsts}, the "
          f"longest {sorted(steps)[-3:]}; {json.dumps(metrics_e2e)}",
          file=log, flush=True)

    result_metrics = {}
    out = {}
    if trace_on:
        ctx = traced_passes(cell, traffic, metrics, entry, device)
        synchronize(device)
        ev = ctx["device_events"]
        window_ns = max(e for _, e, *_ in ev) - ev[0][0] if ev else 0
        ctx["busy_s"] = trace.busy_ns(ev) / 1e9
        ctx["window_s"] = window_ns / 1e9
        for m, spec_m in zip(metrics, per_layer):
            v = m.read(ctx)
            if v is not None:
                result_metrics[spec_m["name"]] = {"value": v,
                                                  "unit": spec_m["unit"]}
        dev.update(busy_s=ctx["busy_s"], window_s=ctx["window_s"])
        out["breakdown"] = breakdown(ctx)
        del ctx
    else:
        units = {m["name"]: m["unit"]
                 for m in load_json(ROOT, "BENCHMARK.json")["end_to_end"]}
        result_metrics = {k: {"value": v, "unit": units[k]}
                          for k, v in metrics_e2e.items() if k in units}
        result_metrics["setup_s"] = {"value": setup_s,
                                     "unit": units["setup_s"]}

    # the output check, once the program's state is freed
    got, (fields, g0, a0) = sampled(cell, traffic, jobs, seed)
    del jobs, cell
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    want = ref.run(spec, fields, g0, a0, dtype="float64", device=device,
                   frames=max(g["Tsb"].shape[1] for g in got))
    numbers, ok, (pos, rot) = compare(got, want, traffic["check"])
    ok = ok and failed == 0
    numbers["failed_rows"] = (float(failed), 0.0)
    print(f"portbench: the {pos.numel()} sampled rows' widest gaps: "
          f"position {quantiles(pos)} m, rotation {quantiles(rot)} (0, "
          f"0.5, 0.9, 1); the largest position gaps "
          f"{[float(f'{v:.3e}') for v in pos.sort().values[-8:]]} m",
          file=log, flush=True)
    for k, (v, lim) in numbers.items():
        print(f"check {k} {v:.6g} limit {lim:.6g}", file=log, flush=True)
    out.update(correct=bool(ok), attempted=attempted, failed=failed,
               metrics=result_metrics, device=dev,
               check={k: {"value": v, "limit": lim}
                      for k, (v, lim) in numbers.items()})
    return out
