"""The port's ``vi_bootstrap`` (``filter/vi_init.py``) and
``validate_state`` (``filter/validate.py``) against the JAX package, on
the CPU in float64.

* ``vi_bootstrap`` on a 16-frame window of the PCW stream, depth-aided
  (the simulation's depths) and visual-only: v0, g, the depths, Rsb0,
  Vsb0 and the residual within 1e-8 of the reference's, ``cond_ok``
  equal (and true), and the recovered gravity's direction and the
  depth-aided velocity near the truth; plus the preintegration alone
  within 1e-12;
* ``validate_state`` gives the reference's error list on the states of
  a 20-frame walk (both forms: the square-root form with every option on,
  and the full form, fast propagation in both), which is empty, and on
  copies of them broken in several ways at once (a slot map that does not
  invert ``sind``, an instate feature with a dead reference and the wrong
  status, a freed slot with covariance, a non-finite and an asymmetric
  covariance).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_pipeline import TINY
from xivo_tpu.filter import vi_init as jvi
from xivo_tpu.filter.validate import validate_state as jax_validate
from xivo_tpu_torch import interop
from xivo_tpu_torch.filter import vi_init as tvi
from xivo_tpu_torch.filter.config import config_from_json
from xivo_tpu_torch.filter.layout import Dims
from xivo_tpu_torch.filter.state import tree_map
from xivo_tpu_torch.filter.validate import validate_state
from xivo_tpu_torch.runner import batch_states, make_batch_runner
from xivo_tpu_torch.sim.configs import OPTIONS, PCW_CALIB_CFG, PCW_CFG
from xivo_tpu_torch.sim.stream import build_pcw_stream

torch.set_num_threads(2)
WINDOW = 16


@pytest.fixture(scope="module")
def window():
    cfg = config_from_json(PCW_CFG, dtype="float64")
    fi, gt = build_pcw_stream(cfg, seed=5, total_time=1.0, noise_px=0.0)
    fi = type(fi)(*(np.asarray(a)[:WINDOW] for a in fi))
    return cfg, fi, gt


def _fields(fi, depth):
    args = [fi.gyro, fi.accel, fi.imu_dt, fi.frame_dt, fi.meas_id,
            fi.meas_xp, fi.meas_valid]
    return args + ([fi.meas_depth] if depth else [])


def test_preintegration_matches_reference(window):
    _, fi, _ = window
    want = jvi._preintegrate(*map(jnp.asarray, _fields(fi, False)[:4]))
    got = tvi._preintegrate(*map(torch.from_numpy, _fields(fi, False)[:4]))
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("depth", [True, False],
                         ids=["depth_aided", "visual_only"])
def test_vi_bootstrap_matches_reference(window, depth):
    cfg, fi, gt = window
    intrin = np.array(cfg.cam_params[2:6] + (0.0,) * 5)
    want = jvi.vi_bootstrap(cfg, jnp.asarray(intrin),
                            *map(jnp.asarray, _fields(fi, depth)))
    got = tvi.vi_bootstrap(cfg, torch.from_numpy(intrin),
                           *map(torch.from_numpy, _fields(fi, depth)))
    for name in want._fields:
        a, b = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        if a.dtype == bool:
            assert b == a and a, name
        else:
            np.testing.assert_allclose(b, a, rtol=1e-8, atol=1e-8,
                                       err_msg=name)
    # gravity points down in the body frame at rest-like starts, and the
    # depth-aided velocity is the truth's (in the b0 frame)
    g = got.g_b0.numpy()
    g_true = gt["Rsb"][0].T @ np.array([0.0, 0.0, -9.8])
    assert np.dot(g, g_true) / (9.8 * 9.8) > 0.99
    if depth:
        v_true = gt["Rsb"][0].T @ gt["Vsb"][0]
        assert np.linalg.norm(got.v0.numpy() - v_true) < 0.05


@pytest.fixture(scope="module")
def walk_states():
    """Final states (batched, two sequences) of 20 frames in the
    square-root form with every option on, and in the full form."""
    out = {}
    for name, over in (("sqrt_options", dict(OPTIONS,
                                              propagation_mode="fast",
                                              covariance_form="sqrt")),
                       ("full", dict(propagation_mode="fast",
                                     covariance_form="full"))):
        cfg = config_from_json(PCW_CALIB_CFG, dims=Dims(*TINY),
                               dtype="float64", sim_initialize_depths=True,
                               **over)
        fi, gt = build_pcw_stream(cfg, seed=1, total_time=1.0, noise_px=0.25)
        s = batch_states(cfg, 2, device="cpu")
        s = s._replace(last_gyro=torch.tensor(gt["gyro0"]).expand(2, 3),
                       last_accel=torch.tensor(gt["accel0"]).expand(2, 3))
        s, _ = make_batch_runner(cfg)(s, type(fi)(*(np.stack([a, a])
                                                    for a in fi)))
        out[name] = (cfg, s)
    return out


def _reference_errors(cfg, s, seq):
    return jax_validate(cfg, tree_map(lambda t: t[seq],
                                      interop.state_to_numpy(s)))


def broken(cfg, s):
    """A copy of sequence 0 of s broken several ways (batch axis kept)."""
    s = tree_map(lambda t: t[:1].clone(), s)
    fr, d = s.features, cfg.dims
    inst = torch.nonzero(fr.sind[0] >= 0)[:, 0]
    a, b = int(inst[0]), int(inst[1])
    f2row = s.f2row.clone()
    f2row[0, int(fr.sind[0, a])] = b                 # map not inverting sind
    ref = fr.ref.clone()
    ref[0, b] = -1                                   # instate, no ref
    status = fr.status.clone()
    status[0, a] = 1                                 # instate, CREATED
    free = int(torch.nonzero(s.g2row[0] < 0)[0, 0]) \
        if bool((s.g2row[0] < 0).any()) else None
    P = s.P.clone()
    P[0, 0, 1] += 1.0                                # asymmetric (dense)
    if free is not None:
        P[0, d.group_off(free) + 1, 0] = 0.5         # freed slot with cov
    P[0, -1, -1] = float("nan")
    return s._replace(f2row=f2row, P=P,
                      features=fr._replace(ref=ref, status=status))


@pytest.mark.parametrize("name", ["sqrt_options", "full"])
def test_validate_state_matches_reference(walk_states, name):
    cfg, s = walk_states[name]
    for seq in (0, 1):
        assert validate_state(cfg, s, seq) == _reference_errors(cfg, s, seq) \
            == []
    bad = broken(cfg, s)
    errs = validate_state(cfg, bad, 0)
    assert errs == _reference_errors(cfg, bad, 0)
    assert validate_state(cfg, tree_map(lambda t: t[0], bad)) == errs
    assert len(errs) >= 5, errs
    assert "non-finite covariance" in errs
