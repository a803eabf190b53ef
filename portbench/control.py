"""The readings the output check's limits are set from, on the card: for
each seed, one job of the cell at its own batch through the program, its
sampled rows held against the float64 reference (the program's
readings); and, on the control seeds, the same reference computed in
float32 with TF32 on, put in the program's place (the control's
readings: the precision step that would tempt a later change, since the
program runs float32 with TF32 off). From the root of a checkout:

    python3 portbench/control.py --workload pcw_sqrt.montecarlo \\
        --seeds 1,2,3,4,5,6 --control-seeds 7,8,9

prints one line of numbers a reading and, with ``--out``, writes them
all as JSON. The benchmark's runs do not run it.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def one_job(cell, device):
    """The outputs of one whole job through the program."""
    carry, outs = cell.fresh(), []
    for t in range(cell.T):
        carry, out = cell.step(carry, t)
        outs.append(out)
    return [outs]


def readings(workload, seed, control, device="cuda", batch=None,
             frames=None, log=sys.stderr):
    """{"program": numbers, "control": numbers or None, "rows": {side:
    [each sampled row's widest position gap, its widest rotation gap]}}
    of one seed; each numbers {name: value} as the output check compares
    them."""
    import torch
    from portbench import harness
    _, spec, traffic, _ = harness.cell_files(workload)
    entry = importlib.import_module(f"portbench.entries.{spec['entry']}")
    ref = importlib.import_module(f"portbench.refs.{spec['entry']}")
    check = traffic["check"]
    t0 = time.perf_counter()
    cell = entry.Cell(spec, traffic, seed, device, batch=batch,
                      frames=frames)
    jobs = one_job(cell, device)
    got, (fields, g0, a0) = harness.sampled(cell, traffic, jobs, seed)
    del jobs, cell
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    want = ref.run(spec, fields, g0, a0, dtype="float64", device=device)
    prog, _, g = harness.compare(got, want, check)
    gaps = {"program": [harness.quantiles(x) for x in g]}
    out = {"program": {k: v for k, (v, _) in prog.items()}, "control": None,
           "rows": {"program": [x.tolist() for x in g]}}
    if control:
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            low = ref.run(spec, fields, g0, a0, dtype="float32",
                          device=device)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32
        ctl, _, g = harness.compare([low], want, check)
        out["control"] = {k: v for k, (v, _) in ctl.items()}
        gaps["control"] = [harness.quantiles(x) for x in g]
        out["rows"]["control"] = [x.tolist() for x in g]
        # the program's own arithmetic without its kernels: the reference
        # in float32 with TF32 off, beside the two
        plain = ref.run(spec, fields, g0, a0, dtype="float32",
                        device=device)
        p32, _, g = harness.compare([plain], want, check)
        out["plain32"] = {k: v for k, (v, _) in p32.items()}
        gaps["plain32"] = [harness.quantiles(x) for x in g]
        out["rows"]["plain32"] = [x.tolist() for x in g]
    print(f"control {workload} seed {seed}: the rows' widest position and "
          f"rotation gaps (0, 0.5, 0.9, 1): {json.dumps(gaps)}", file=log,
          flush=True)
    shown = {k: v for k, v in out.items() if k != "rows"}
    print(f"control {workload} seed {seed}: {json.dumps(shown)} "
          f"({time.perf_counter() - t0:.1f} s)", file=log, flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl = [int(s) for s in args.control_seeds.split(",") if s]
    res = [dict(seed=s, **readings(args.workload, s, s in ctl))
           for s in seeds + [s for s in ctl if s not in seeds]]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(workload=args.workload, readings=res), f)


if __name__ == "__main__":
    main()
