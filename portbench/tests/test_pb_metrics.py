"""The benchmark's arithmetic on the CPU: the end-to-end metrics over a
window, and each roofline's least time against hand counts at the
shapes of ``PERF.md``'s kernel table."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import harness, trace
from portbench.metrics import chol_roofline_pct
from portbench.peaks import bound


def outs(offsets):
    """One job's per-frame outputs: frame t's positions (B, 1, 3) are the
    rows' offsets[t] along x."""
    return [SimpleNamespace(Tsb=torch.tensor(o, dtype=torch.float32)
                            .reshape(-1, 1, 1) * torch.tensor([1.0, 0, 0]))
            for o in offsets]


def test_window_metrics_take_every_frame_and_a_partial_job():
    cell = SimpleNamespace(B=2, T=4, gt_Tsb=torch.zeros(
        2, 4, 3, dtype=torch.float64))
    full = outs([[0.0, 0.0], [1.0, 1.0], [0.0, 0.0], [1.0, 1.0]])
    partial = outs([[3.0, 3.0], [0.0, float("nan")]])
    steps = [10.0] * 6
    m, attempted, failed = harness.e2e_metrics(cell, 2.0, steps,
                                               [full, partial])
    # the rate counts the partial job's frames too
    assert m["seq_frames_per_s"] == 2 * 6 / 2.0
    # the error, the whole job's: 1 + 1 over 4 frames, both rows
    assert m["ate_rmse_m"] == pytest.approx(np.sqrt(4 / 8))
    # the partial job's row that left the finite numbers fails
    assert (attempted, failed) == (4, 1)


def test_a_row_that_leaves_the_finite_numbers_fails_and_leaves_the_ate():
    cell = SimpleNamespace(B=2, T=2, gt_Tsb=torch.zeros(
        2, 2, 3, dtype=torch.float64))
    job = outs([[1.0, float("nan")], [1.0, 0.0]])
    m, attempted, failed = harness.e2e_metrics(cell, 1.0, [1.0, 1.0], [job])
    assert (attempted, failed) == (2, 1)
    assert m["ate_rmse_m"] == pytest.approx(1.0)


def test_step_tail_shows_one_stall():
    times = np.cumsum([0.0] + [10.0] * 19 + [250.0])   # ms, 20 steps
    steps = list(np.diff(times))
    assert harness.step_p95(steps) > 10.0 + 0.04 * 240
    assert harness.step_p95([10.0] * 20) == 10.0


def test_busy_is_the_union_of_the_device_intervals():
    ev = [(0, 10, "a", 0), (5, 12, "b", 0), (20, 25, "c", 0)]
    assert trace.busy_ns(ev) == 17


@pytest.mark.parametrize("name,m,ms", [("chol_lanes", 228, 0.0239),
                                       ("chol_inv_lanes", 60, 0.0028),
                                       ("tri_inv_lanes", 60, 0.0017)])
def test_cholesky_least_times(name, m, ms):
    path = f"xivo_tpu_torch.ops.lanes_chol:{name}"
    assert chol_roofline_pct.least_ms(path, ((256, m, m),)) == \
        pytest.approx(ms, abs=5e-5)


def test_traced_readers_on_a_made_up_context():
    from portbench.metrics import (device_idle_pct, launches_per_step,
                                   propagate_sync_ms, update_sync_ms)
    chol = "xivo_tpu_torch.ops.lanes_chol:chol_lanes"
    ctx = dict(
        stages={"propagate": "m:propagate_frame", "update": "m:update"},
        device_events=[(0, 10, "k", 0), (20, 30, "k", 0)],
        device_frames=2, busy_s=20e-9, window_s=30e-9,
        sync={"m:propagate_frame": 0.5}, sync_calls={"m:propagate_frame": 4},
        sync_frames=4,
        host={chol: [(0.0239e-3 * 4, 1)]}, host_args={chol: [((256, 228,
                                                               228),)]},
        host_events=[(0, 10, "k", "m:update"), (15, 20, "k", None)])
    assert launches_per_step.read(ctx) == 1.0
    assert device_idle_pct.read(ctx) == pytest.approx(100 / 3)
    assert propagate_sync_ms.read(ctx) == pytest.approx(125.0)
    # a stage that never ran reads nothing
    assert update_sync_ms.read(ctx) is None
    assert chol_roofline_pct.read(ctx) == pytest.approx(25.0, rel=2e-3)
    b = harness.breakdown(ctx)
    assert b["device_ops"] == [["k", 20e-9]]
    assert b["idle_gaps"] == [["outside the ranges", 5e-9]]
