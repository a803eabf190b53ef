"""Spans of the frame step, stamped on the profiler's clock.

Off by default, and nothing in the package turns it on. An operator (or
the benchmark) calls ``enable()``, runs frames, and reads ``records()``:

    from xivo_tpu_torch import tracing
    tracing.enable()
    ...                         # run_batch(...) or any runner
    spans = tracing.records()   # [Span, ...] since the last clear()
    tracing.disable()

``span(name)`` is both a context manager and a decorator. Off, it makes
one test of the module's flag, then runs the code or returns a no-op
context made once for that name: no clock is read, nothing is allocated,
no ``record_function`` is made and no hook is installed. On, each span
closed appends a ``Span``:

- ``id``, and ``parent``: the id of the innermost span open on the same
  thread when it opened (None at the top); one stack a thread.
- ``frame``: the sequence number of the frame step (``FRAME`` span) that
  holds it; every span of one frame step shares it; -1 outside any.
- ``name``, ``start_ns``, ``end_ns``: ``time.time_ns()``, the Unix clock
  on which ``torch.profiler`` stamps its events, so that spans lie on a
  profiler trace's timeline as they are.
- ``info``: for a ``FRAME`` span in a process that has started CUDA, the
  caching allocator's device allocations (``device_allocs``) and
  allocation retries (``alloc_retries``) during it; for a ``GC`` span,
  the collection's ``generation`` and the objects it ``collected``;
  otherwise None.

While on, a ``gc.callbacks`` hook records a ``GC`` span for each
collection, as a child of the span open on the collecting thread.
``enable()`` installs it and ``disable()`` removes it.

Where the spans are (names below): ``runner``'s frame loops (``FRAME``,
the frame's draws and its step), ``filter/pipeline.py`` (``PROPAGATE``
and its children in fast propagation, ``TRACKER``, ``UPDATE`` and its
children), the entries of ``ops/lanes_chol.py`` (B1-B3, named after
their functions).
"""
from __future__ import annotations

import functools
import gc
import itertools
import threading
import time
from typing import NamedTuple, Optional

import torch

# batch runner
FRAME = "frame"
# propagation: pipeline.propagate_frame; its children in
# pipeline._propagate_frame_fast and ops/imu_chain
PROPAGATE = "propagate"
IMU_SLOTS = "imu_slots"              # the loop over the IMU slots (on the
#                                      card: the whole chain's one launch)
VISUAL_SEGMENT = "visual_segment"    # extrapolation to the frame time (on
#                                      the CPU); the OC correction
COV_PROPAGATE = "cov_propagate"      # the factor's or dense block's update
# tracker: pipeline.tracker_pointcloud
TRACKER = "tracker"
# filter update: pipeline.update_step and its children
UPDATE = "update"
TRACKS = "tracks"                    # _process_tracks
ADMISSION = "admission"              # depth refinement, admissions, init
GATING = "gating"                    # stacked Jacobian, MH distances, gate
HYGIENE = "hygiene"                  # destroy, discard, gauge, 1-pt RANSAC
EKF_UPDATE = "ekf_update"            # stale Jacobians, update, absorb
BOOKKEEPING = "bookkeeping"          # the rest
# kernels: ops/lanes_chol.py's entries (B1-B3)
CHOL_LANES = "chol_lanes"
CHOL_INV_LANES = "chol_inv_lanes"
TRI_INV_LANES = "tri_inv_lanes"
# host: the garbage collector
GC = "gc"


class Span(NamedTuple):
    id: int
    parent: Optional[int]
    frame: int
    name: str
    start_ns: int
    end_ns: int
    info: Optional[dict] = None


_on = False
_records = []
_ids = itertools.count()
_frames = itertools.count()
_local = threading.local()
_idle = {}


def enable():
    """Start recording spans, and install the garbage collector's hook."""
    global _on
    if _gc_hook not in gc.callbacks:
        gc.callbacks.append(_gc_hook)
    _on = True


def disable():
    """Stop recording spans (those open still record when they close),
    and remove the hook."""
    global _on
    _on = False
    if _gc_hook in gc.callbacks:
        gc.callbacks.remove(_gc_hook)


def records():
    """A copy of the spans closed since the last ``clear()``, in the
    order they closed."""
    return list(_records)


def clear():
    _records.clear()


def span(name: str):
    """A span named `name`: ``with span(name): ...`` or ``@span(name)``."""
    if not _on:
        idle = _idle.get(name)
        return idle if idle is not None else _idle.setdefault(name,
                                                              _Idle(name))
    return _Open(name)


def _traced(name, fn):
    @functools.wraps(fn)
    def traced(*args, **kw):
        if not _on:
            return fn(*args, **kw)
        with _Open(name):
            return fn(*args, **kw)
    return traced


class _Idle:
    """What ``span`` gives while tracing is off: a no-op context, and a
    decorator whose wrapper tests the flag at each call."""
    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        return _traced(self.name, fn)


def _stack():
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _alloc_counts():
    """(device allocations, allocation retries) of the caching allocator
    on the current device; None before CUDA has started."""
    if not torch.cuda.is_initialized():
        return None
    s = torch.cuda.memory_stats_as_nested_dict()
    return s.get("num_device_alloc", 0), s.get("num_alloc_retries", 0)


class _Open:
    __slots__ = ("name", "id", "parent", "frame", "start", "counts")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        st = _stack()
        top = st[-1] if st else None
        self.id = next(_ids)
        self.parent = None if top is None else top.id
        if self.name == FRAME:
            self.frame = next(_frames)
            self.counts = _alloc_counts()
        else:
            self.frame = -1 if top is None else top.frame
            self.counts = None
        st.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _stack().pop()
        info = None
        if self.counts is not None:
            a, r = _alloc_counts()
            info = {"device_allocs": a - self.counts[0],
                    "alloc_retries": r - self.counts[1]}
        _records.append(Span(self.id, self.parent, self.frame, self.name,
                             self.start, end, info))
        return False

    def __call__(self, fn):
        return _traced(self.name, fn)


def _gc_hook(phase, info):
    if phase == "start":
        st = _stack()
        _local.gc = (time.time_ns(), st[-1] if st else None)
        return
    begun = getattr(_local, "gc", None)
    if begun is None:       # installed while a collection ran
        return
    _local.gc = None
    t0, top = begun
    _records.append(Span(
        next(_ids), None if top is None else top.id,
        -1 if top is None else top.frame, GC, t0, time.time_ns(),
        {"generation": info["generation"], "collected": info["collected"]}))
