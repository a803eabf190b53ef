"""``xivo_tpu_torch.tracing`` on the CPU: the spans of a PCW run, their
nesting and frame numbers, that tracing changes no output, that it is
silent while off, the garbage collector's spans, and that a span's
clock is the one ``torch.profiler`` stamps its ranges with."""
import gc
import time

import numpy as np
import pytest
import torch

from xivo_tpu_torch import tracing
from xivo_tpu_torch.filter.config import config_from_json
from xivo_tpu_torch.filter.layout import Dims
from xivo_tpu_torch.filter.state import tree_map
from xivo_tpu_torch.runner import (FrameInputs, batch_states,
                                   inputs_to_device, run_batch)
from xivo_tpu_torch.sim.configs import PCW_CFG
from xivo_tpu_torch.sim.stream import build_pcw_stream

B, FRAMES = 2, 4
STAGES = (tracing.PROPAGATE, tracing.TRACKER, tracing.UPDATE)
CHILDREN = {
    tracing.PROPAGATE: (tracing.IMU_SLOTS, tracing.VISUAL_SEGMENT,
                        tracing.COV_PROPAGATE),
    tracing.UPDATE: (tracing.TRACKS, tracing.ADMISSION, tracing.GATING,
                     tracing.HYGIENE, tracing.EKF_UPDATE,
                     tracing.BOOKKEEPING)}


@pytest.fixture
def traced():
    """Tracing off and empty before and after the test."""
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


@pytest.fixture(scope="module")
def pcw():
    """(config, states, inputs) of B PCW sequences at tiny Dims."""
    cfg = config_from_json(PCW_CFG, dims=Dims(4, 8, 16, 32),
                           dtype="float64", sim_initialize_depths=True,
                           propagation_mode="fast", covariance_form="sqrt")
    streams = [build_pcw_stream(cfg, total_time=FRAMES * 0.05,
                                noise_px=0.25, seed=sd) for sd in (1, 2)]
    fi = FrameInputs(*(np.stack(x) for x in zip(*[f for f, _ in streams])))
    s = batch_states(cfg, B, "cpu")
    s = s._replace(
        last_gyro=torch.from_numpy(np.stack([g["gyro0"] for _, g in
                                             streams])),
        last_accel=torch.from_numpy(np.stack([g["accel0"] for _, g in
                                              streams])))
    return cfg, s, inputs_to_device(fi, "cpu")


def run(pcw):
    cfg, s, fi = pcw
    return run_batch(cfg, tree_map(torch.clone, s), fi)


def test_a_run_gives_one_frame_span_a_step_with_its_stages_inside(
        traced, pcw):
    tracing.enable()
    run(pcw)
    tracing.disable()
    spans = tracing.records()
    by_id = {r.id: r for r in spans}
    frames = [r for r in spans if r.name == tracing.FRAME]
    assert len(frames) == FRAMES
    assert [f.frame for f in frames] == list(
        range(frames[0].frame, frames[0].frame + FRAMES))
    assert all(f.parent is None for f in frames)
    for f in frames:
        inside = [r for r in spans if r.frame == f.frame and r is not f]
        for r in inside:            # closed, within the parent, one frame
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
            assert p.frame == f.frame
        stages = [r for r in inside if r.parent == f.id]
        assert [r.name for r in stages if r.name != tracing.GC] \
            == list(STAGES)
        for st in stages:
            if st.name not in CHILDREN:
                continue
            kids = [r.name for r in inside
                    if r.parent == st.id and r.name != tracing.GC]
            assert kids == list(CHILDREN[st.name])
        # the square-root update's three kernel entries (B1-B3) inside
        names = {r.name for r in inside}
        assert {tracing.CHOL_LANES, tracing.CHOL_INV_LANES,
                tracing.TRI_INV_LANES} <= names
        starts = [r.start_ns for r in stages]
        assert starts == sorted(starts)
    # no CUDA here: no allocator counts
    assert all(f.info is None for f in frames)


def test_tracing_changes_no_output(traced, pcw):
    s0, o0 = run(pcw)
    tracing.enable()
    s1, o1 = run(pcw)
    tracing.disable()
    assert tracing.records()
    for a, b in zip(o0, o1):
        assert torch.equal(a, b)
    leaves = []
    tree_map(leaves.append, (s0, s1))
    n = len(leaves) // 2
    assert n and all(torch.equal(a, b) if isinstance(a, torch.Tensor)
                     else a == b for a, b in zip(leaves[:n], leaves[n:]))


def test_off_records_nothing_and_installs_no_hook(traced, pcw):
    run(pcw)
    gc.collect()
    with tracing.span(tracing.FRAME):
        pass
    assert tracing.records() == []
    assert not any(getattr(cb, "__module__", None) == tracing.__name__
                   for cb in gc.callbacks)
    # off, a span is one shared object a name: nothing is made a call
    assert tracing.span("x") is tracing.span("x")
    tracing.enable()
    assert sum(getattr(cb, "__module__", None) == tracing.__name__
               for cb in gc.callbacks) == 1
    tracing.enable()
    assert sum(getattr(cb, "__module__", None) == tracing.__name__
               for cb in gc.callbacks) == 1


def test_a_collection_inside_a_span_is_its_child(traced):
    tracing.enable()
    with tracing.span(tracing.FRAME):
        with tracing.span(tracing.UPDATE):
            junk = [[i] for i in range(100)]
            for a, b in zip(junk, junk[1:]):
                a.append(b)
                b.append(a)
            del junk, a, b
            gc.collect()
    tracing.disable()
    spans = tracing.records()
    upd = next(r for r in spans if r.name == tracing.UPDATE)
    frame = next(r for r in spans if r.name == tracing.FRAME)
    gcs = [r for r in spans if r.name == tracing.GC]
    assert gcs
    g = gcs[-1]
    assert g.parent == upd.id and g.frame == frame.frame == upd.frame
    assert upd.start_ns <= g.start_ns <= g.end_ns <= upd.end_ns
    assert g.info["generation"] == 2 and g.info["collected"] >= 100


def test_the_decorator_tests_the_flag_at_each_call(traced):
    @tracing.span("decorated")
    def f(x):
        return x + 1

    assert f(1) == 2 and tracing.records() == []
    tracing.enable()
    assert f(2) == 3
    tracing.disable()
    assert [r.name for r in tracing.records()] == ["decorated"]
    assert f.__name__ == "f"


def test_spans_lie_on_the_profilers_clock(traced):
    """A span around a ``record_function`` range holds the range, which
    starts within 5 ms of the span: both are on the Unix clock."""
    from torch.profiler import ProfilerActivity, profile, record_function
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("outer"):
            with record_function("inner_range"):
                torch.ones(64).sum()
                time.sleep(0.002)
    tracing.disable()
    outer = next(r for r in tracing.records() if r.name == "outer")
    rng = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "inner_range"]
    assert len(rng) == 1
    s, e = rng[0].start_ns(), rng[0].start_ns() + rng[0].duration_ns()
    assert outer.start_ns <= s <= e <= outer.end_ns
    assert s - outer.start_ns < 5_000_000
