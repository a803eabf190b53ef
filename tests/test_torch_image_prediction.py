"""The port's image-mode frame step against the JAX package with the
tracker's optional branches on: the filter's pixel prediction as LK's
initial guess (``use_prediction``), the descriptor-drift gate
(``descriptor_distance_thresh`` 64) and the dropped-track rescue
(``match_dropped_tracks``).

Same run and tolerances as ``tests/test_torch_image_pipeline.py`` (12
frames, B = 2, tiny Dims, float64), in a file of its own so that the
test workers take the two runs in parallel.
"""
import numpy as np
import pytest

from test_torch_image_pipeline import (check_outputs, check_tables,
                                       image_cfgs, run_both)

OPTIONS = dict(use_prediction=True, descriptor_distance_thresh=64,
               match_dropped_tracks=True)


@pytest.fixture(scope="module")
def runs():
    jc, tc = image_cfgs(**OPTIONS)
    for k, v in OPTIONS.items():
        assert getattr(jc, k) == getattr(tc, k) == v
    return run_both(jc, tc)


def test_vio_frame_image_with_prediction_matches_reference(runs):
    (_, _, jo), (_, _, to) = runs
    check_outputs(jo, to)
    assert int(np.asarray(jo.num_tracked)[:, 1:].min()) > 0
    assert int(np.asarray(jo.num_instate_features)[:, -1].min()) > 0


def test_track_table_with_prediction_matches_reference(runs):
    (js, jf, _), (ts, tf, _) = runs
    check_tables(js, ts, jf, tf)
