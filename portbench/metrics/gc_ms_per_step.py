"""``gc_ms_per_step``: host ms in the program's ``gc`` spans (Python's
garbage collector) inside ``frame`` spans, over every frame step the
traced run recorded (warm-up, window and passes), over their number;
None where the device pass's frames were not found (``_spans``)."""
from __future__ import annotations

from . import _spans


def read(ctx):
    if _spans.device_pass(ctx) is None:
        return None
    spans = _spans.records()
    frames = sum(r.name == "frame" for r in spans)
    gc_ns = sum(r.end_ns - r.start_ns for r in spans
                if r.name == "gc" and r.frame >= 0)
    return gc_ns / 1e6 / frames
