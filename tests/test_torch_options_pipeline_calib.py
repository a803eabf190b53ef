"""Depth refinement, online camera calibration and every filter option
together through ``vio_frame`` against the JAX package, on the CPU in
float64: the rest of ``test_torch_options_pipeline.py``'s cases, in a
file of their own so that the two run side by side (the module docstring
there describes the walks and what each case asserts). ``all`` is
``sim.configs.OPTIONS``: OOS updates, FEJ and the correlated init under
the six options.
"""
import pytest
import torch

from tests.test_torch_options_pipeline import CASES, check_case, run_case

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["use_depth_opt", "online_camera_calib",
                                  "all"])
def test_option_matches_reference_over_20_frames(name):
    check_case(name, run_case(CASES[name]))
