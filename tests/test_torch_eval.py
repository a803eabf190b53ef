"""The port's eval (``xivo_tpu_torch/eval``: numpy copies of the JAX
package's ``metrics``, ``geometry`` and ``estimator_data``) against the
reference's, exactly, on seeded inputs: TUM association with jittered
stamps and a greedy conflict, Horn alignment, ATE and RPE, hand-eye
rotation, trajectory alignment, the Allan deviation and the noise
densities, and the dump reader on both dump formats."""
import json

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from xivo_tpu.eval import estimator_data as jax_data
from xivo_tpu.eval import geometry as jax_geometry
from xivo_tpu.eval import metrics as jax_metrics
from xivo_tpu_torch.eval import estimator_data, geometry, metrics


def trajectories(seed=0, n=120):
    rng = np.random.default_rng(seed)
    t_gt = np.arange(n) * 0.05
    T_gt = np.cumsum(rng.standard_normal((n, 3)) * 0.05, axis=0)
    R_gt = Rotation.from_rotvec(np.cumsum(
        rng.standard_normal((n, 3)) * 0.02, axis=0)).as_matrix()
    t_est = t_gt + rng.uniform(-4e-4, 4e-4, n)
    R0 = Rotation.from_rotvec([0.1, -0.2, 0.3]).as_matrix()
    T_est = T_gt @ R0.T + [1.0, 2.0, 3.0] + rng.standard_normal((n, 3)) * 1e-2
    R_est = R0 @ R_gt
    return t_est, R_est, T_est, t_gt, R_gt, T_gt


def _cases():
    t_est, R_est, T_est, t_gt, R_gt, T_gt = trajectories()
    rng = np.random.default_rng(1)
    A = rng.standard_normal((12, 3))
    X = Rotation.from_rotvec([0.3, 0.1, -0.2]).as_matrix()
    imu = rng.standard_normal((4000, 3))
    return {
        "associate": ("metrics", "associate", (t_est, t_gt)),
        "associate_conflict": ("metrics", "associate",
                               ([0.0, 0.0006, 1.0], [0.0004, 0.9999])),
        "horn_align": ("metrics", "horn_align", (T_est, T_gt)),
        "ate_rmse": ("metrics", "ate_rmse", (t_est, T_est, t_gt, T_gt)),
        "rpe": ("metrics", "rpe", (t_est, R_est, T_est, t_gt, R_gt, T_gt)),
        "hand_eye_rotation": ("geometry", "hand_eye_rotation",
                              (A @ X.T, A)),
        "trajectory_alignment": ("geometry", "trajectory_alignment",
                                 (T_gt, T_est)),
        "allan_deviation": ("geometry", "allan_deviation",
                            (imu[:, 0], 100.0)),
        "noise_densities": ("geometry", "identify_noise_densities",
                            (imu, imu * 0.1, 100.0)),
    }


CASES = _cases()


def assert_identical(a, b):
    if isinstance(b, dict):
        assert a.keys() == b.keys()
        for k in b:
            assert_identical(a[k], b[k])
    elif isinstance(b, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_identical(x, y)
    else:
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype


@pytest.mark.parametrize("case", list(CASES))
def test_matches_reference(case):
    mod, fn, args = CASES[case]
    port = {"metrics": metrics, "geometry": geometry}[mod]
    ref = {"metrics": jax_metrics, "geometry": jax_geometry}[mod]
    got, want = getattr(port, fn)(*args), getattr(ref, fn)(*args)
    assert_identical(got, want)
    if case == "ate_rmse":
        assert want[1] > 100 and want[0] < 0.05


def _dumps(tmp_path):
    rng = np.random.default_rng(2)
    frames = [dict(ts=0.05 * i, **{k: rng.standard_normal(3).tolist()
                                   for k in ("Tsb", "Wsb", "Vsb", "bg", "ba",
                                             "Tbc", "Wbc")},
                   td=float(rng.standard_normal()) * 1e-3,
                   num_instate_features=int(rng.integers(0, 30)),
                   num_instate_groups=int(rng.integers(0, 15)),
                   Pstate=(np.eye(39) * rng.random(39)).tolist())
              for i in range(6)]
    state = tmp_path / "state.json"
    state.write_text(json.dumps(frames))

    def q(w):
        x, y, z, qw = Rotation.from_rotvec(w).as_quat()
        return [qw, x, y, z]
    cov = tmp_path / "cov.json"
    cov.write_text(json.dumps({"data": [dict(
        Timestamp=f["ts"], Tsb_XYZ=f["Tsb"], qsb_WXYZ=q(f["Wsb"]),
        Vsb_XYZ=f["Vsb"], bg=f["bg"], ba=f["ba"], Tbc_XYZ=f["Tbc"],
        qbc_WXYZ=q(f["Wbc"]), td=f["td"],
        num_instate_features=f["num_instate_features"],
        num_instate_groups=f["num_instate_groups"], Pstate=f["Pstate"])
        for f in frames]}))
    return str(state), str(cov)


@pytest.mark.parametrize("fmt", ["state", "cov"])
def test_estimator_data_matches_reference(tmp_path, fmt):
    path = dict(zip(("state", "cov"), _dumps(tmp_path)))[fmt]
    got, want = estimator_data.EstimatorData(path), \
        jax_data.EstimatorData(path)
    assert len(got) == len(want) == 6
    for k in ("ts", "Tsb", "Wsb", "Vsb", "bg", "ba", "Tbc", "Wbc", "td",
              "num_instate_features", "num_instate_groups", "Pstate"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    for block in estimator_data.BLOCKS:
        np.testing.assert_array_equal(got.sigma(block), want.sigma(block))
    for block in ("Tsb", "td"):
        assert got.within_sigma_fraction(block, 0.1) == \
            want.within_sigma_fraction(block, 0.1)
    assert estimator_data.BLOCKS == jax_data.BLOCKS


def test_load_trajectory_matches_reference(tmp_path):
    p = tmp_path / "traj.txt"
    rows = np.random.default_rng(3).standard_normal((7, 8))
    p.write_text("\n".join(" ".join(f"{x:.9f}" for x in r) for r in rows))
    got = estimator_data.load_trajectory(str(p))
    want = jax_data.load_trajectory(str(p))
    assert_identical(got, want)
