"""The port's ``Estimator`` against the JAX package's on a stream that
exercises its reorder buffer, float64 on the CPU (see
``test_torch_api.py`` for the stream, the tolerances and ``default``):
``sqrt_td_reordered``, the square-root form with fast propagation and
online temporal calibration from td = 9 ms, ``message_buffer_size=10``,
visual stamps 3 ms off the IMU grid (so that the td-shifted ordering key
of each visual message sorts it after the next IMU sample,
``src/estimator.cpp:943-951``) and every group of 8 packets delivered in
reverse (``tests/test_api.py::test_message_reordering_bit_identical``).
The port's result is also bit for bit its in-order result.
"""
import numpy as np
import pytest
import torch

from xivo_tpu_torch.api import Estimator

from test_torch_api import (RUN_T, RUNS, cfgs, check_pair, feed, messages,
                            run_pair)

torch.set_num_threads(2)
RUN = "sqrt_td_reordered"


@pytest.fixture(scope="module")
def pair():
    return run_pair(RUN)


def test_matches_reference(pair):
    check_pair(pair)
    (_, est), _ = pair
    assert est.num_misordered_dropped() == 0
    assert est.cfg.online_temporal_calib
    assert est.cfg.covariance_form == "sqrt"
    over, offset, _ = RUNS[RUN]
    assert est.td() != over["X_td"]
    # delivery order does not change the result
    tc = cfgs(**over)[1]
    in_order = Estimator(tc, device="cpu")
    feed(in_order, messages(tc, T=RUN_T, offset=offset))
    for name in ("gsb", "Vsb", "P", "InstateFeatureIDs"):
        a, b = getattr(in_order, name)(), getattr(est, name)()
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(x, y)


def test_td_shift_reorders_visual_messages():
    """With td = 9 ms, each visual message (3 ms past an IMU stamp) sorts
    after the next IMU sample, so every frame integrates an IMU sample
    stamped after it; without the shift, none does."""
    over = dict(RUNS[RUN][0])
    late = {}
    for td in (0.0, over["X_td"]):
        tc = cfgs(**dict(over, X_td=td, P_td=0.0))[1]
        est = Estimator(tc, device="cpu")
        seen = []
        run = est._run_frame
        est._run_frame = lambda ts, imu, *a: (
            seen.append((len(imu), imu and imu[-1][0] > ts)),
            run(ts, imu, *a))
        feed(est, messages(tc, T=0.5, offset=0.003))
        late[td] = seen[1:]
    assert late[0.0] == [(5, False)] * 9
    assert late[over["X_td"]] == [(5, True)] * 9
