"""The whole run of a cell on the CPU at a small size, past the look for
a card: sound, it comes out correct; with the timed path broken
underneath, it does not. The faults a cell of this benchmark can have:
a frame step that returns its state unchanged; half of the batch left
out, its rows given the other half's results; an answer altered where it
is produced. (The exchange between chips does not exist on the
benchmark's one-card cells.)"""
import pytest
import torch

from portbench import harness

B, FRAMES, SEED = 4, 8, 2 ** 31 + 11


def unchanged(cell):
    def step(carry, t):
        _, out = cell.step(carry, t)
        return carry, out
    return step


def half_left_out(cell):
    h = cell.B // 2

    def step(carry, t):
        carry, out = cell.step(carry, t)
        return carry, type(out)(*(torch.cat([o[:h], o[:cell.B - h]])
                                  for o in out))
    return step


def answer_altered(cell):
    """Frame 3's answers moved 1 cm where the step produces them."""
    def step(carry, t):
        carry, out = cell.step(carry, t)
        if t == 3:
            out = out._replace(Tsb=out.Tsb + torch.tensor([0.01, 0, 0]))
        return carry, out
    return step


def run(workload, fault=None):
    return harness.run_cell(workload, SEED, 0.0, False, device="cpu",
                            batch=B, frames=FRAMES, fault=fault,
                            window_frames=FRAMES)


@pytest.mark.parametrize("workload", ["pcw_sqrt.montecarlo"])
def test_a_sound_run_is_correct(workload):
    out = run(workload)
    assert out["correct"], out["check"]
    assert list(out)[-1] == "check"
    assert set(out["metrics"]) == {"seq_frames_per_s", "step_ms_p95",
                                   "ate_rmse_m", "setup_s"}


@pytest.mark.parametrize("fault", [unchanged, half_left_out,
                                   answer_altered])
def test_a_broken_step_is_caught(fault):
    out = run("pcw_sqrt.montecarlo", fault)
    assert not out["correct"], out["check"]

