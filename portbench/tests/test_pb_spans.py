"""The span readers (``metrics/_spans.py`` and the four metrics on it) on
made-up contexts and spans, and the ``pcw_sqrt.imu200`` cell's whole run
on the CPU at a small size."""
import pytest

from portbench import harness
from xivo_tpu_torch import tracing
from xivo_tpu_torch.tracing import Span

MS = 1_000_000


@pytest.fixture
def spans(monkeypatch):
    """The span helpers, reading the list the test fills; tracing (which
    importing them turns on) off again afterwards."""
    from portbench.metrics import _spans
    made = []
    monkeypatch.setattr(_spans, "records", lambda: list(made))
    yield _spans, made
    tracing.disable()
    tracing.clear()


def frame(made, n, t0, t1, children=(), gcs=()):
    """Frame n's span over [t0, t1) ms, its children (name, start, end)
    ms, and collections (start, end) ms inside the first child."""
    fid = 1000 * n
    made.append(Span(fid, None, n, "frame", t0 * MS, t1 * MS))
    for k, (name, s, e) in enumerate(children, 1):
        made.append(Span(fid + k, fid, n, name, s * MS, e * MS))
    for k, (s, e) in enumerate(gcs, 100):
        made.append(Span(fid + k, fid + 1, n, "gc", s * MS, e * MS,
                         {"generation": 2, "collected": 0}))


def ctx(events_ms, n_frames=2):
    return dict(device_events=[(s * MS, e * MS, "k", 0)
                               for s, e in events_ms],
                device_frames=n_frames)


def two_frames(made):
    """Warm-up frame 0, then frames 1-2 in the device pass, then a host
    pass's frame 3, each with a propagate and an update span."""
    frame(made, 0, 0, 10, [("propagate", 0, 4), ("update", 5, 10)],
          gcs=[(1, 3)])
    frame(made, 1, 20, 30, [("propagate", 20, 26), ("update", 26, 30)])
    frame(made, 2, 30, 40, [("propagate", 30, 32), ("update", 32, 40)],
          gcs=[(30, 31)])
    frame(made, 3, 60, 70, [("propagate", 60, 64), ("update", 64, 70)])


def test_the_device_pass_is_picked_by_the_clock(spans):
    sp, made = spans
    two_frames(made)
    frames, inside = sp.device_pass(ctx([(21, 25), (28, 45)]))
    assert [f.frame for f in frames] == [1, 2]
    assert {r.frame for r in inside} == {1, 2}
    assert "frame" not in {r.name for r in inside}
    from portbench.metrics import propagate_issue_ms, update_issue_ms
    c = ctx([(21, 25), (28, 45)])
    assert propagate_issue_ms.read(c) == pytest.approx(4.0)
    assert update_issue_ms.read(c) == pytest.approx(6.0)


def test_a_count_that_does_not_match_reads_nothing(spans):
    sp, made = spans
    two_frames(made)
    from portbench.metrics import (gc_ms_per_step, idle_in_propagate_pct,
                                   propagate_issue_ms, update_issue_ms)
    for c in (ctx([(21, 25), (28, 45)], n_frames=3),   # a frame missed
              ctx([(21, 25), (28, 65)]),              # the host pass's too
              ctx([])):                               # no device work
        for m in (propagate_issue_ms, update_issue_ms,
                  idle_in_propagate_pct, gc_ms_per_step):
            assert m.read(c) is None


def test_a_program_without_spans_reads_nothing(spans, monkeypatch):
    sp, made = spans
    two_frames(made)
    monkeypatch.setattr(sp, "tracing", None)
    from portbench.metrics import idle_in_propagate_pct, propagate_issue_ms
    c = ctx([(21, 25), (28, 45)])
    assert propagate_issue_ms.read(c) is None
    assert idle_in_propagate_pct.read(c) is None


def test_idle_is_placed_by_the_host_spans(spans):
    """Device busy [21, 23) and [27, 45): the one gap [23, 27) lies 3 of
    its 4 ms in frame 1's propagate span [20, 26), the rest in its
    update."""
    sp, made = spans
    two_frames(made)
    from portbench.metrics import idle_in_propagate_pct
    c = ctx([(21, 23), (27, 45)])
    assert idle_in_propagate_pct.read(c) == pytest.approx(75.0)
    # a gap half inside propagate counts half
    c = ctx([(21, 24), (28, 45)])
    assert idle_in_propagate_pct.read(c) == pytest.approx(50.0)
    by = sp.idle_by_leaf(c)
    assert by == {"propagate": 2 * MS, "update": 2 * MS,
                  sp.BETWEEN: 0}


def test_idle_by_leaf_names_the_innermost_span(spans):
    sp, made = spans
    frame(made, 1, 0, 20, [("update", 2, 18), ("ekf_update", 5, 9)],
          gcs=[(6, 8)])
    frame(made, 2, 30, 40, [("propagate", 30, 40)])
    made.append(Span(5000, None, -1, "gc", 24 * MS, 26 * MS))
    c = ctx([(0, 1), (19, 22), (39, 41)])
    by = sp.idle_by_leaf(c)
    # gaps [1, 19) and [22, 39)
    # frame 1's own time [1, 2) and [18, 19); update [2, 5) and [9, 18);
    # ekf_update [5, 6) and [8, 9) around the collection [6, 8); the
    # collection between frames [24, 26); frame 2's propagate [30, 39);
    # nothing open [22, 24) and [26, 30)
    assert by == {"frame": 2 * MS, "update": 12 * MS, "ekf_update": 2 * MS,
                  "gc": 4 * MS, "propagate": 9 * MS, sp.BETWEEN: 6 * MS}
    assert sum(by.values()) == 35 * MS


def test_gc_ms_over_every_recorded_frame(spans):
    sp, made = spans
    two_frames(made)
    made.append(Span(5000, None, -1, "gc", 50 * MS, 59 * MS))  # no frame
    from portbench.metrics import gc_ms_per_step
    # 2 ms in frame 0 and 1 ms in frame 2, over the 4 frames recorded
    assert gc_ms_per_step.read(ctx([(21, 25), (28, 45)])) == \
        pytest.approx(0.75)


def test_leaf_pieces_cut_nested_spans():
    from portbench.metrics._spans import leaf_pieces
    s = [Span(1, None, 0, "a", 0, 10), Span(2, 1, 0, "b", 2, 4),
         Span(3, 1, 0, "c", 4, 7), Span(4, 3, 0, "d", 5, 6),
         Span(5, None, 0, "e", 12, 13)]
    assert leaf_pieces(s) == [(0, 2, "a"), (2, 4, "b"), (4, 5, "c"),
                              (5, 6, "d"), (6, 7, "c"), (7, 10, "a"),
                              (12, 13, "e")]


def test_the_imu200_cell_runs_and_is_correct():
    out = harness.run_cell("pcw_sqrt.imu200", 2 ** 31 + 7, 0.0, False,
                           device="cpu", batch=4, frames=8,
                           window_frames=8)
    assert out["correct"], out["check"]
    assert set(out["metrics"]) == {"seq_frames_per_s", "step_ms_p95",
                                   "ate_rmse_m", "setup_s"}


def test_the_span_report_rehearses_on_the_cpu(capsys):
    """The report's run on the CPU (no device events): every program span
    of the host pass lies inside the benchmark's range around the same
    call."""
    import json
    from portbench import span_report
    try:
        assert span_report.main(["--workload", "pcw_sqrt.montecarlo",
                                 "--seed", "5", "--device", "cpu",
                                 "--batch", "2", "--frames", "3"]) == 0
    finally:
        tracing.disable()
        tracing.clear()
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["job"]["frames"] == 3 and out["job"]["idle_pct"] is None
    for name in ("propagate", "update"):
        got = out["host_pass"][name]
        assert got["spans"] == 3 and got["all_inside"], got
