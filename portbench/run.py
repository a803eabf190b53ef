"""The benchmark of ``xivo_tpu_torch`` on the card: one run of one cell.

From the root of a checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

prints, as the last line of its standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device``, with ``--trace 1`` a ``breakdown``, and last ``check``: each
number the output check compared, beside its limit. The same numbers
are the last lines of its standard error. It exits non-zero, and prints
no result, without a card (or with fewer than the cell asks for), or if
a module of JAX or of the JAX package is loaded once the window closes.
"""
from __future__ import annotations

import os
import time


def process_start() -> float:
    """This process's start on the ``time.time`` clock (from /proc; now
    where that cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

FORBIDDEN = ("jax", "jaxlib", "flax", "xivo_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from portbench import harness
    w = harness.cell_files(args.workload)[0]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < w["chips"]:
        print(f"portbench: {args.workload} needs {w['chips']} CUDA "
              f"device(s); found {found}", file=sys.stderr)
        return 1
    start = time.perf_counter() - (time.time() - T_START)
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), device="cuda", t_start=start)
    found = forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: "
              f"{found}", file=sys.stderr)
        return 1
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
