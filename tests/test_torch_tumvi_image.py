"""The shipped TUM-VI configs through the port, against the JAX package on
the CPU in float64.

* ``check_supported`` accepts ``cfg/tumvi_cam0.json`` and
  ``cfg/tumvi_cam0_accuracy.json`` unmodified, and with the MATCH
  tracker, the GFTT detector or the ORB descriptor;
* ``vio_frame_image`` with ``cfg/tumvi_cam0.json``'s settings: the
  equidistant lens, prediction-seeded LK with the descriptor gate and
  dropped-track rescue, homography outlier rejection (the reference's
  draws rebuilt from its key each frame), the reference's Prince-Dormand
  propagation and the full covariance. Six frames of two sequences of the
  stream rendered through that lens (``build_image_stream``), at the tiny
  Dims with the default admission gate (``image_cfgs``; the config's gate
  of 0.02 admits no feature in six frames), from one initial state.
  In frames 3 and 4 the image's left strip is moved 8 px down
  (``displaced``): the tracks there (7 of 32) leave the homography of the
  rest in frame 3 and come back in frame 5, so the rejection fires in both
  frames, ahead of the descriptor-drift gate, which keeps those tracks
  (the strip moves whole, so their descriptors do not change).
  Held as tests/test_torch_image_pipeline.py holds its runs: tracks
  within 5e-6 px, poses and the rest within 5e-7, counts (rejections
  included), ids and track states exactly.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from test_torch_image_pipeline import (check_outputs, check_tables,
                                       image_cfgs, run_both)
from xivo_tpu.filter.config import load_json_with_comments
from xivo_tpu_torch.filter.config import config_from_json
from xivo_tpu_torch.filter.state import check_supported

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = ("tumvi_cam0.json", "tumvi_cam0_accuracy.json")
FRAMES = 6


def shipped(name):
    return load_json_with_comments(os.path.join(ROOT, "cfg", name))


@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_tumvi_configs_are_supported(name):
    cfg = config_from_json(shipped(name))
    assert (cfg.cam_model, cfg.do_outlier_rejection) == ("equidistant", True)
    check_supported(cfg)
    for over in ({"tracker_type": "MATCH"}, {"detector": "GFTT"},
                 {"descriptor_type": "orb"}):
        check_supported(dataclasses.replace(cfg, **over))


def displaced(image):
    """(B, T, H, W) images with columns 0-39 moved 8 px down in frames 3
    and 4."""
    image = image.copy()
    image[:, 3:5, 8:, :40] = image[:, 3:5, :-8, :40]
    return image


@pytest.fixture(scope="module")
def runs():
    jc, tc = image_cfgs(raw=shipped("tumvi_cam0.json"), modes={})
    assert (tc.cam_model, tc.propagation_mode, tc.covariance_form,
            tc.use_prediction, tc.do_outlier_rejection) == (
        "equidistant", "reference", "full", True, True)
    return run_both(jc, tc, frames=FRAMES, edit=displaced)


def test_vio_frame_image_tumvi_matches_reference(runs):
    (_, _, jo), (_, _, to) = runs
    check_outputs(jo, to, frames=FRAMES)
    # the run did real work: tracks held and features entered the state
    # (run_both checked that the reference drew its homography uniforms
    # from its key on every frame)
    assert int(jo.num_tracked[:, 1:].min()) > 0
    assert int(jo.num_instate_features[:, -1].min()) > 0
    # the displaced strip's tracks were rejected when it moved, and only
    # then
    rejected = np.asarray(jo.num_tracker_outlier_rejected)
    assert rejected[:, [3, 5]].min() > 0
    assert not rejected[:, [0, 1, 2, 4]].any()


def test_tumvi_track_table_and_pyramid_match_reference(runs):
    (js, jf, _), (ts, tf, _) = runs
    check_tables(js, ts, jf, tf)
