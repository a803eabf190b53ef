"""``device_idle_pct``: the share of the device pass's span, from the
first device event to the end of the last, in which no kernel, copy or
set ran (100 - the union of the device intervals over the span)."""
from __future__ import annotations


def read(ctx):
    if ctx["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
