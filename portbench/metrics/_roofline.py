"""What the roofline metrics share: the least time of the work that a set
of program functions was given, over the device time of everything
launched inside the benchmark's ranges around those calls (the traced
run's host pass), so that the share reads the same work whatever kernel
does it. A metric module lists the functions to range, as
"module:function", in ``RANGES``, and those whose arguments its work
count needs whole in ``KEEP_ARGS``."""
from __future__ import annotations


def share_pct(ctx, paths, least_ms):
    """100 x sum of least_ms(path, args) over the calls of `paths` / their
    device time; None where no call ran any device work."""
    least = device = 0.0
    for p in paths:
        calls, args_of = ctx["host"].get(p, []), ctx["host_args"].get(p, [])
        if len(calls) != len(args_of):
            return None     # a call whose device work the trace missed
        for (dev_s, _), args in zip(calls, args_of):
            least += least_ms(p, args)
            device += dev_s * 1e3
    if device <= 0:
        return None
    return 100.0 * least / device
