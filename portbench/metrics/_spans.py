"""What the span metrics share: the program's own spans
(``xivo_tpu_torch.tracing``), stamped on the clock that the profiler's
device events carry, read after the traced passes.

Importing this module turns the program's tracing on: the harness imports
metric modules only under ``--trace 1``, before it builds the cell, so a
``--trace 0`` run never traces. A program without ``tracing`` gives
nothing to read, and every reader returns None.

The device pass's frames are the ``frame`` spans whose host interval
overlaps the device events' span (the first event's start to the last
one's end): the passes around it end in a synchronize, so the cut is
clean. Where their number differs from the pass's frames, the two clocks
do not agree, and every reader returns None.
"""
from __future__ import annotations

try:
    from xivo_tpu_torch import tracing
except ImportError:         # a program that has no spans
    tracing = None
else:
    tracing.enable()


def records():
    return tracing.records() if tracing is not None else []


def device_window(ctx):
    """(first device event's start, last one's end) ns of the device
    pass; None where it ran nothing."""
    ev = ctx["device_events"]
    if not ev:
        return None
    return ev[0][0], max(e for _, e, *_ in ev)


def device_pass(ctx):
    """(the device pass's ``frame`` spans, every span those frames hold),
    picked by the shared clock; None where the count differs from the
    pass's frames or nothing was traced."""
    win = device_window(ctx)
    if tracing is None or win is None:
        return None
    lo, hi = win
    spans = records()
    frames = [r for r in spans if r.name == tracing.FRAME
              and r.start_ns < hi and r.end_ns > lo]
    if len(frames) != ctx["device_frames"]:
        return None
    ids = {f.frame for f in frames}
    return frames, [r for r in spans if r.frame in ids
                    and r.name != tracing.FRAME]


def issue_ms(ctx, name):
    """Host ms a frame step inside spans named `name`, over the device
    pass's frames (nothing synchronized)."""
    sel = device_pass(ctx)
    if sel is None:
        return None
    frames, inside = sel
    return sum(r.end_ns - r.start_ns for r in inside
               if r.name == name) / 1e6 / len(frames)


def idle_gaps(events):
    """[(start, end)] ns: the gaps in the union of the device events'
    intervals (sorted by start), within their span."""
    gaps, cur = [], None
    for s, e, *_ in events:
        if cur is not None and s > cur:
            gaps.append((cur, s))
        cur = e if cur is None else max(cur, e)
    return gaps


def overlaps(a, b):
    """[(index into b, ns)]: where two sorted lists of disjoint intervals
    meet, and for how long."""
    i = j = 0
    out = []
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out.append((j, hi - lo))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def overlap_ns(a, b):
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    return sum(ns for _, ns in overlaps(a, b))


def idle_share_in(ctx, name):
    """% of the device pass's idle time during which the host was inside
    a span named `name` of the pass's frames."""
    sel = device_pass(ctx)
    if sel is None:
        return None
    gaps = idle_gaps(ctx["device_events"])
    idle = sum(e - s for s, e in gaps)
    if idle <= 0:
        return None
    inside = sorted((r.start_ns, r.end_ns) for r in sel[1]
                    if r.name == name)
    return 100.0 * overlap_ns(gaps, inside) / idle


def leaf_pieces(spans):
    """[(start, end, name)]: the union of properly nested spans (one
    thread's) cut by the innermost span open, in time order."""
    out, stack = [], []                 # [span, where its own time resumes]

    def pop():
        sp, cur = stack.pop()
        if sp.end_ns > cur:
            out.append((cur, sp.end_ns, sp.name))
        if stack:
            stack[-1][1] = sp.end_ns

    for r in sorted(spans, key=lambda r: (r.start_ns, -r.end_ns)):
        while stack and stack[-1][0].end_ns <= r.start_ns:
            pop()
        if stack and r.start_ns > stack[-1][1]:
            out.append((stack[-1][1], r.start_ns, stack[-1][0].name))
        stack.append([r, r.start_ns])
    while stack:
        pop()
    return sorted(out)


BETWEEN = "between spans"


def idle_by_leaf(ctx):
    """{innermost span name, or BETWEEN: ns} of the device pass's idle
    time: each gap cut by the span the host was innermost in, the device
    pass's frames' spans and every collection within the pass; None as
    ``device_pass``."""
    sel = device_pass(ctx)
    if sel is None:
        return None
    lo, hi = device_window(ctx)
    frames, inside = sel
    gcs = [r for r in records() if r.name == tracing.GC and r.frame < 0
           and r.start_ns < hi and r.end_ns > lo]
    gaps = idle_gaps(ctx["device_events"])
    out = {BETWEEN: sum(e - s for s, e in gaps)}
    pieces = leaf_pieces(frames + inside + gcs)
    for j, ns in overlaps(gaps, pieces):
        name = pieces[j][2]
        out[name] = out.get(name, 0) + ns
        out[BETWEEN] -= ns
    return out
