"""What the stage-time metrics share: a stage's ms a frame step, read in
the traced run's synchronized pass (``trace.Timed``). A metric module
names the stage by its role (``ROLE``); each entry maps roles to its
program functions (``STAGES`` in ``entries/<entry>.py``)."""
from __future__ import annotations


def stage_ms(ctx, role):
    """ms a frame step in the program function that plays `role` for the
    cell's entry; None where the entry has no such stage or it never
    ran."""
    path = ctx["stages"].get(role)
    if path is None or not ctx["sync_calls"].get(path):
        return None
    return ctx["sync"][path] * 1e3 / ctx["sync_frames"]
