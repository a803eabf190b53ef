"""What the benchmark reads from the device and the host in a traced run:
the profiler's raw device events, the benchmark's own ``record_function``
ranges around program functions, and stage times with the card
synchronized around each call.

``raw_device_events`` is ``chip_smoke.py``'s ``device_events`` event by
event, and ``Timed`` a frozen copy of its ``Timed``; ``busy_ns``,
``Ranges`` and ``attribute`` are the benchmark's own. Nothing of the
program is imported: a range or a stage names a program function by
module path and attribute, and is patched in with ``setattr`` while its
``with`` block runs.
"""
from __future__ import annotations

import importlib
import time


def raw_device_events(prof):
    """[(start ns, end ns, name, linked correlation id)] of every kernel,
    copy and set that ran on the device, in start order, from the
    profiler's raw events (``key_averages()`` first builds the whole event
    tree: 11-33 s a path on the H100)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if "CUDA" not in str(e.device_type()) or e.duration_ns() <= 0 \
                or e.is_user_annotation():
            continue
        out.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
                    e.linked_correlation_id()))
    out.sort()
    return out


def busy_ns(events):
    """Length of the union of the events' [start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e, *_ in events:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def resolve(path: str):
    """(module, attribute) of "package.module:attribute"."""
    mod, attr = path.split(":")
    return importlib.import_module(mod), attr


class Timed:
    """Replace module functions by wrappers that synchronize the card
    before and after each call and add its wall time to a total by stage,
    while the `with` block runs. `patches` are "module:function" paths;
    the totals are keyed by path, with the number of calls."""

    def __init__(self, torch, patches):
        self.torch, self.patches = torch, list(dict.fromkeys(patches))
        self.total = {p: 0.0 for p in self.patches}
        self.calls = {p: 0 for p in self.patches}

    def __enter__(self):
        self.orig = [(*resolve(p), p) for p in self.patches]
        self.orig = [(m, n, getattr(m, n), p) for m, n, p in self.orig]
        for m, n, fn, p in self.orig:
            setattr(m, n, self._wrap(p, fn))
        return self

    def _wrap(self, path, fn):
        def timed(*args, **kw):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            self.torch.cuda.synchronize()
            self.total[path] += time.perf_counter() - t0
            self.calls[path] += 1
            return out
        return timed

    def __exit__(self, *exc):
        for m, n, fn, _ in self.orig:
            setattr(m, n, fn)


class Ranges:
    """Wrap module functions in ``record_function`` ranges named by their
    "module:function" path while the `with` block runs. Each call's
    arguments are kept: tensors by their shapes, and for the paths in
    `keep` as clones."""

    def __init__(self, torch, patches, keep=()):
        self.torch = torch
        self.patches = list(dict.fromkeys(patches))
        self.keep = set(keep)
        self.args = {p: [] for p in self.patches}

    def __enter__(self):
        self.orig = []
        for p in self.patches:
            m, n = resolve(p)
            self.orig.append((m, n, getattr(m, n), p))
        for m, n, fn, p in self.orig:
            setattr(m, n, self._wrap(p, fn))
        return self

    def _wrap(self, path, fn):
        rf = self.torch.profiler.record_function
        torch = self.torch

        def ranged(*args, **kw):
            if path in self.keep:
                self.args[path].append(tuple(
                    a.clone() if isinstance(a, torch.Tensor) else a
                    for a in args))
            else:
                self.args[path].append(tuple(
                    tuple(a.shape) if isinstance(a, torch.Tensor) else a
                    for a in args))
            with rf(path):
                return fn(*args, **kw)
        return ranged

    def __exit__(self, *exc):
        for m, n, fn, _ in self.orig:
            setattr(m, n, fn)


def device_ranges(prof, names):
    """[(name, start ns, end ns)] of the device-side spans of the user
    ranges in `names`: the profiler lays each range that launched device
    work onto the device's timeline, from its first kernel's start to its
    last kernel's end. In start order."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation() and e.name() in names \
                and "CUDA" in str(e.device_type()):
            out.append((e.name(), e.start_ns(), e.start_ns()
                        + e.duration_ns()))
    out.sort(key=lambda r: r[1])
    return out


def attribute(prof, names):
    """Device work launched inside each range: {name: [(device s of one
    call's kernels, kernels), ...]} in call order, one entry a call with
    device work, and the device events with the innermost range each ran
    in ([(start, end, kernel, range name or None)]). One stream runs the
    frame step, so a kernel belongs to a range when it ran within the
    range's span on the device."""
    ranges = device_ranges(prof, set(names))
    dev = raw_device_events(prof)
    per_call = [[0, 0] for _ in ranges]
    tagged = []
    lo = 0
    for s, e, name, _ in dev:
        while lo < len(ranges) and ranges[lo][2] < s:
            lo += 1
        inner = None
        for i in range(lo, len(ranges)):
            rn, rs, re_ = ranges[i]
            if rs > s:
                break
            if e <= re_:
                per_call[i][0] += e - s
                per_call[i][1] += 1
                if inner is None or rs >= ranges[inner][1]:
                    inner = i
        tagged.append((s, e, name, None if inner is None
                       else ranges[inner][0]))
    out = {n: [] for n in names}
    for (n, *_), (ns, k) in zip(ranges, per_call):
        out[n].append((ns / 1e9, k))
    return out, tagged
