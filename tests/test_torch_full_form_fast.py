"""Fast propagation through the port's ``vio_frame`` against the JAX
package, float64 on the CPU: 10 frames of the tiny PCW config in the full
form (``pcw_fast_full``: the dense-P branch of the frame propagation) and
with ``fast_substeps=0`` in the square-root form (``pcw_fast_loop``: the
capped fixed-step loop and the skipped per-frame projection; ROADMAP C.1,
where the port had propagated nothing). The checks and their tolerances
are ``test_torch_full_form.py``'s."""
import pytest

from test_torch_full_form import check_final_state, check_frames, run_case


@pytest.fixture(scope="module", params=["pcw_fast_full", "pcw_fast_loop"])
def run(request):
    return run_case(request.param)


def test_fast_propagation_frames_match_reference(run):
    check_frames(run)


def test_fast_propagation_final_state_matches_reference(run):
    check_final_state(run)
