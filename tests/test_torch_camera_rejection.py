"""The PCW path through the TUM-VI configs' lens (equidistant) with the
homography outlier rejection on, the port against the JAX package on the
CPU in float64: tests/test_torch_camera_pipeline.py's run (``check_run``;
see its module docstring), with a ninth of the measurements jumping 25 px
each frame and the reference's homography draws rebuilt from its key.
The radtan lens runs without the rejection there; the rejection reads
only pixels, whatever lens made them."""
import pytest

from test_torch_camera_pipeline import check_run


@pytest.mark.parametrize("cam", ["equidistant"])
def test_vio_frame_with_rejection_matches_reference(cam):
    check_run(cam, rejection=True)
