"""``launches_per_step``: kernels, copies and sets the device ran a frame
step, counted from the profiler's raw device events over the traced run's
device pass."""
from __future__ import annotations


def read(ctx):
    if not ctx["device_events"]:
        return None
    return len(ctx["device_events"]) / ctx["device_frames"]
