"""The port's ``Estimator`` (the pyxivo surface) against the JAX package's,
and against the port's own batch runners, on the CPU in float64.

Against the JAX ``Estimator``: ``tests/test_api.py::run_short``'s stream
(the gentle IMU trajectory, 300 random points, 100 Hz IMU, 20 Hz frames),
its first RUN_T = 1 s (20 frames; features are in the state from frame 3)
made once with the port's simulator and fed to both, at the tiny Dims of
``__graft_entry__._tiny_cfg``. Each run is module-scoped:

* ``default`` (here): ``config_from_json(PCW_CFG)``'s default filter
  (reference propagation, full covariance), depths from the simulation;
* ``sqrt_td_reordered`` (``test_torch_api_stream.py``): the square-root
  form with online temporal calibration from a nonzero td and the
  reorder buffer on, so that the td shift moves visual messages past IMU
  ones, with the stream delivered in reversed groups of 8 packets
  (``tests/test_api.py::test_message_reordering_*``).

Every value accessor of ``tests/test_api.py``'s ``PYXIVO_METHODS`` agrees
at the end within 1e-8 (of the largest entry, for arrays), the pose
within 1e-8 m at every frame, and the counts and
``num_misordered_dropped`` exactly.

Against the port itself, bit for bit where the same arithmetic runs:
``make_sequence_runner`` against ``run_batch``; checkpoint/resume; the
straggler drop; tracker-only mode; ``EstimatorProcess`` against the
synchronous estimator; and the rejection counters on
``tests/test_api.py::test_rejection_counters_wired``'s corrupted frames
(``do_outlier_rejection`` and ``use_1pt_RANSAC``) against the JAX
``Estimator``, frame by frame. The mapped and image estimators against
their runners are in ``test_torch_api_runners.py``.
"""
import numpy as np
import pytest
import torch

from xivo_tpu.api import Estimator as JaxEstimator
from xivo_tpu.filter.config import config_from_json as jax_config_from_json
from xivo_tpu.filter.layout import Dims as JaxDims
from xivo_tpu.sim.configs import PCW_CFG as JAX_PCW_CFG
from xivo_tpu_torch.api import Estimator, EstimatorProcess
from xivo_tpu_torch.filter.config import config_from_json
from xivo_tpu_torch.filter.layout import Dims
from xivo_tpu_torch.runner import make_sequence_runner, run_batch
from xivo_tpu_torch.sim.configs import PCW_CFG
from xivo_tpu_torch.sim.imu_sim import get_imu_sim
from xivo_tpu_torch.sim.pcw import RandomPCW
from xivo_tpu_torch.sim.stream import RUN_SHORT_K, run_short_messages

from test_api import PYXIVO_METHODS
from test_torch_homography import tracker_draws
from test_torch_pipeline import TINY, plain

torch.set_num_threads(2)
TOL = 1e-8
SQRT = dict(propagation_mode="fast", covariance_form="sqrt")
# the pyxivo methods that feed or change the estimator, or draw
ENTRY_POINTS = {"InertialMeas", "VisualMeas", "VisualMeasTrackerOnly",
                "VisualMeasPointCloud", "VisualMeasPointCloudTrackerOnly",
                "CloseLoop", "InitWithSimDepths", "ScaleInitVelocity",
                "Visualize"}
ACCESSORS = [m for m in PYXIVO_METHODS if m not in ENTRY_POINTS]
# run -> (config overrides, visual stamp offset, reversed groups)
RUN_T = 1.0        # seconds of run_short's stream each pair is fed
RUNS = {
    "default": ({}, 0.0, 0),
    "sqrt_td_reordered": (dict(SQRT, online_temporal_calib=True,
                               X_td=0.009, P_td=0.002,
                               message_buffer_size=10), 0.003, 8),
}


def cfgs(dtype="float64", **over):
    """(reference config, port config) of PCW_CFG at the tiny Dims,
    depths from the simulation."""
    kw = dict(dtype=dtype, sim_initialize_depths=True, **over)
    jc = jax_config_from_json(JAX_PCW_CFG, dims=JaxDims(*TINY), **kw)
    tc = config_from_json(PCW_CFG, dims=Dims(*TINY), **kw)
    assert plain(jc) == plain(tc)
    return jc, tc


def messages(tc, **kw):
    """``run_short``'s stream (``sim.stream.run_short_messages``) for the
    config's camera placement."""
    return run_short_messages(*Estimator(tc, device="cpu").gbc(), **kw)


def reversed_groups(msgs, n):
    """Every group of n consecutive messages delivered in reverse."""
    if not n:
        return msgs
    out = []
    for i in range(0, len(msgs), n):
        out.extend(reversed(msgs[i:i + n]))
    assert out != msgs
    return out


def feed(est, msgs, flush=True):
    for t, kind, a, b in msgs:
        if kind == "imu":
            est.InertialMeas(t, a, b)
        else:
            est.VisualMeasPointCloud(t, a, b)
    if flush:
        est.flush()


def record_frames(est):
    """Record (pose, counts) after every visual frame the estimator
    executes, whichever package it is from."""
    frames = []
    run = est._run_frame

    def recorded(*args):
        run(*args)
        frames.append((est.gsb(), [
            est.num_instate_features(), est.num_instate_groups(),
            est.num_tracked_features(), est.num_mh_rejected(),
            est.num_tracker_outlier_rejected()]))
    est._run_frame = recorded
    return frames


def run_pair(run):
    """Both packages' estimators after the run's stream, with the frames
    each recorded."""
    over, offset, groups = RUNS[run]
    jc, tc = cfgs(**over)
    msgs = reversed_groups(messages(tc, T=RUN_T, offset=offset), groups)
    ests, frames = [], []
    for est in (JaxEstimator(jc), Estimator(tc, device="cpu")):
        frames.append(record_frames(est))
        feed(est, msgs)
        ests.append(est)
    return ests, frames


def assert_agree(name, ref, got):
    """ref (the JAX estimator's) and got (the port's) agree: strings,
    bools and integers exactly, floats within TOL of their largest
    magnitude (at least 1)."""
    if isinstance(ref, tuple):
        assert isinstance(got, tuple) and len(got) == len(ref), name
        for r, g in zip(ref, got):
            assert_agree(name, r, g)
        return
    if isinstance(ref, (str, bool, type(None))):
        assert got == ref, name
        return
    ref, got = np.asarray(ref), np.asarray(got)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    if ref.dtype.kind in "iub":
        np.testing.assert_array_equal(got, ref, err_msg=name)
        return
    scale = max(1.0, float(np.max(np.abs(ref)))) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * scale,
                               err_msg=name)


def check_pair(pair):
    (jest, test), (jframes, tframes) = pair
    for name in ACCESSORS:
        assert_agree(name, getattr(jest, name)(), getattr(test, name)())
    assert test.num_misordered_dropped() == jest.num_misordered_dropped()
    assert len(tframes) == len(jframes) >= round(RUN_T * 20) - 1
    for i, ((jpose, jn), (tpose, tn)) in enumerate(zip(jframes, tframes)):
        assert tn == jn, (i, tn, jn)
        assert_agree(f"pose of frame {i}", jpose, tpose)
    assert test.num_instate_features() > 0


@pytest.fixture(scope="module")
def default_pair():
    return run_pair("default")


def test_pyxivo_method_surface():
    est = Estimator(cfgs()[1], device="cpu")
    missing = [m for m in PYXIVO_METHODS if not hasattr(est, m)]
    assert not missing, missing


def test_default_filter_matches_reference(default_pair):
    check_pair(default_pair)
    est = default_pair[0][1]
    assert est.cfg.propagation_mode == "reference"
    assert est.cfg.covariance_form == "full"


def test_cuda_by_default():
    """Without a card, an estimator built for the default device raises;
    the CPU runs only when asked for."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Estimator(cfgs(**SQRT)[1])


def test_sequence_runner_matches_run_batch():
    """``make_sequence_runner`` is ``run_batch`` at B = 1, bit for bit."""
    from xivo_tpu_torch.filter.state import init_state
    from xivo_tpu_torch.runner import batch_states, inputs_to_device
    from xivo_tpu_torch.sim.stream import build_pcw_stream
    tc = cfgs(**SQRT)[1]
    fi, _ = build_pcw_stream(tc, total_time=0.5, noise_px=0.25)
    s, outs = make_sequence_runner(tc)(init_state(tc, "cpu"), fi)
    sb, outs_b = run_batch(tc, batch_states(tc, 1, "cpu"), inputs_to_device(
        type(fi)(*(a[None] for a in fi)), "cpu"))
    assert s.P.shape == sb.P.shape[1:] and outs.Tsb.shape == (10, 3)
    assert torch.equal(s.P, sb.P[0]) and torch.equal(outs.Tsb, outs_b.Tsb[0])
    assert torch.equal(outs.num_instate_features,
                       outs_b.num_instate_features[0])


def test_checkpoint_resume(tmp_path):
    """A resumed estimator continues exactly as the one it was saved from
    (state, reorder buffer and generator: the homography draws of the
    frames after the checkpoint come from the saved generator state)."""
    tc = cfgs(**SQRT, message_buffer_size=4, do_outlier_rejection=True)[1]
    msgs = messages(tc, offset=0.003)
    head = [m for m in msgs if m[0] < 1.5]
    tail = msgs[len(head):len(head) + 12]
    est = Estimator(tc, device="cpu")
    feed(est, head, flush=False)
    assert est._buf
    ck = str(tmp_path / "ck.pkl")
    est.save_checkpoint(ck)
    est2 = Estimator(tc, device="cpu")
    est2.load_checkpoint(ck)
    assert est2.vision_initialized and len(est2._buf) == len(est._buf)
    np.testing.assert_array_equal(est2.gsb()[1], est.gsb()[1])
    for e in (est, est2):
        feed(e, tail)
    assert est.now() > 1.55
    for name in ("gsb", "Vsb", "P", "InstateFeatureIDs"):
        assert_agree(name, getattr(est, name)(), getattr(est2, name)())
        np.testing.assert_array_equal(np.asarray(getattr(est, name)()[0]),
                                      np.asarray(getattr(est2, name)()[0]))


def test_message_reordering_drops_stragglers():
    """A message delayed beyond the buffer window is dropped and counted
    (GoodTimestamp, src/estimator.cpp:1108-1110)."""
    tc = cfgs(**SQRT, message_buffer_size=5)[1]
    imu = get_imu_sim("gentle", T=3.0, noise_accel=0, noise_gyro=0, seed=1)
    est = Estimator(tc, device="cpu")
    times = list(np.arange(0, 1.0, 0.01))
    straggler = times.pop(10)
    for t in times + [straggler]:
        a, g = imu.meas(t)
        est.InertialMeas(t, g, a)
    est.flush()
    assert est.num_misordered_dropped() == 1


def test_tracker_only_mode():
    """Point-cloud tracker association only: tracks, no filter."""
    tc = cfgs()[1]
    est = Estimator(tc, device="cpu", tracker_only=True)
    pcw = RandomPCW([-10, 10], [-10, 10], [-5, 5], n_points=300, seed=0)
    Rbc, Tbc = est.gbc()
    for t in np.arange(0, 0.5, 0.05):
        ids, xpd = pcw.generate_measurements(Rbc, Tbc, RUN_SHORT_K, 640,
                                             480, 0.0)
        est.VisualMeasPointCloud(t, ids, xpd)
    fid, xp = est.tracked_features_no_descriptor()
    assert len(fid) == tc.dims.nf_rows and len(xp) == len(fid)
    assert not est.MeasurementUpdateInitialized()
    assert est.num_instate_features() == 0
    assert np.allclose(est.gsb()[1], 0.0)
    assert est.now() == pytest.approx(0.45)


def test_process_matches_synchronous():
    """``EstimatorProcess``'s worker thread gives the synchronous
    estimator's results, bit for bit, and publishes after every frame."""
    tc = cfgs(**SQRT)[1]
    msgs = messages(tc, T=1.0)
    sync = Estimator(tc, device="cpu")
    feed(sync, msgs)
    proc = EstimatorProcess(Estimator(tc, device="cpu"))
    poses, nav = [], []
    proc.pose_callbacks.append(lambda ts, R, T, P: poses.append((ts, T)))
    proc.nav2d_callbacks.append(lambda ts, x, y, yaw: nav.append(yaw))
    proc.Start()
    for t, kind, a, b in msgs:
        (proc.InertialMeas if kind == "imu"
         else proc.VisualMeasPointCloud)(t, a, b)
    proc.Wait()
    proc.Stop()
    n_frames = sum(m[1] == "pc" for m in msgs)
    assert len(poses) == len(nav) == n_frames
    np.testing.assert_array_equal(poses[-1][1], sync.gsb()[1])
    np.testing.assert_array_equal(proc.est.P(), sync.P())


def test_homography_counter_on_corrupted_frames():
    """The rejection counters against the JAX ``Estimator`` on
    ``tests/test_api.py::test_rejection_counters_wired``'s corrupted
    frames, with its ``do_outlier_rejection`` and ``use_1pt_RANSAC``: the
    port takes the homography draws the reference takes from its key
    (``test_torch_homography.tracker_draws``), and then both counters
    equal the reference's frame by frame. The homography gate rejects the
    corrupted pixels from frame 5 on and nothing before; what it leaves
    are within 3 px, below the 1-point RANSAC's 5 px split, so that both
    packages count no 1-point rejection here."""
    jc, tc = cfgs(**SQRT, do_outlier_rejection=True, use_1pt_RANSAC=True)
    msgs = messages(tc, T=1.5, corrupt_from=5)

    def counted(est, before=None):
        counts = []
        run = est._run_frame

        def recorded(*args):
            if before is not None:
                before()
            run(*args)
            counts.append((est.num_tracker_outlier_rejected(),
                           est.num_oneptransac_rejected()))
        est._run_frame = recorded
        return counts

    jest = JaxEstimator(jc)
    keys = []
    want = counted(jest, lambda: keys.append(np.asarray(jest.state.key)))
    feed(jest, msgs)
    est = Estimator(tc, device="cpu")
    draws = iter(torch.tensor(tracker_draws(np.stack(keys),
                                            tc.dims.nf_rows)[1]))
    est._draws = lambda mapped=False: (next(draws)[None], None)
    got = counted(est)
    feed(est, msgs)
    assert len(got) == 30 and got == want, (got, want)
    trk = [c[0] for c in got]
    assert sum(trk[:5]) == 0 and sum(trk[5:]) > 0, trk
    assert all(c[1] == 0 for c in got), got
    np.testing.assert_allclose(est.gsb()[1], jest.gsb()[1], rtol=0, atol=TOL)
