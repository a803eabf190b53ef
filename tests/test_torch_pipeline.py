"""The port's whole slice against the JAX package, on the CPU.

* ``config_from_json`` builds a config equal, field for field, to the
  reference's (the PCW config and every shipped ``cfg/*.json``);
* ``build_pcw_stream`` packs a stream bit-equal to the reference's;
* ``vio_frame``: 20 frames of two PCW sequences at the tiny Dims of
  ``__graft_entry__._tiny_cfg`` in float64, the same initial state carried
  across with ``interop``. Poses agree within 1e-8 (the two packages run
  the same float64 algebra in another operation order; the difference
  seen is ~1e-14) and the integer counts of ``StepOutputs`` match exactly;
* the package imports no JAX, its entry points run on CUDA unless given
  ``device="cpu"``, and the filter options outside this slice raise.

``jax_cfg``/``torch_cfg`` are shared with the other ``test_torch_*`` files.
"""
import dataclasses
import glob
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xivo_tpu.filter.config import config_from_json as jax_config_from_json
from xivo_tpu.filter.config import load_json_with_comments
from xivo_tpu.filter.layout import Dims as JaxDims
from xivo_tpu.runner import batch_states as jax_batch_states
from xivo_tpu.runner import make_batch_runner as jax_batch_runner
from xivo_tpu.sim.configs import PCW_CFG as JAX_PCW_CFG
from xivo_tpu.sim.stream import build_pcw_stream as jax_stream
from xivo_tpu_torch import interop
from xivo_tpu_torch.filter.config import config_from_json
from xivo_tpu_torch.filter.layout import Dims
from xivo_tpu_torch.runner import batch_states, make_batch_runner
from xivo_tpu_torch.sim.configs import PCW_CFG
from xivo_tpu_torch.sim.stream import build_pcw_stream

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = (4, 8, 16, 32)        # n_groups, n_features, ng_rows, nf_rows
SLICE = dict(sim_initialize_depths=True, propagation_mode="fast",
             covariance_form="sqrt")
FRAMES = 20
SEEDS = (1, 2)


def jax_cfg(dtype="float64", dims=TINY):
    return jax_config_from_json(JAX_PCW_CFG, dims=JaxDims(*dims),
                                dtype=dtype, **SLICE)


def torch_cfg(dtype="float64", dims=TINY):
    return config_from_json(PCW_CFG, dims=Dims(*dims), dtype=dtype, **SLICE)


def plain(x):
    """A config as nested builtins, so two packages' configs compare."""
    if dataclasses.is_dataclass(x):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, (tuple, list)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


def _shipped():
    return sorted(glob.glob(os.path.join(ROOT, "cfg", "*.json")))


@pytest.mark.parametrize("case", ["pcw_f32_default_dims", "pcw_f64_tiny"]
                         + [os.path.basename(p) for p in _shipped()])
def test_config_from_json_matches_reference(case):
    if case == "pcw_f32_default_dims":
        a = jax_config_from_json(JAX_PCW_CFG, dtype="float32", **SLICE)
        b = config_from_json(PCW_CFG, dtype="float32", **SLICE)
        assert b.dims.full == 228
    elif case == "pcw_f64_tiny":
        a, b = jax_cfg(), torch_cfg()
    else:
        raw = load_json_with_comments(os.path.join(ROOT, "cfg", case))
        a, b = jax_config_from_json(raw), config_from_json(raw)
    assert type(a).__name__ == type(b).__name__
    assert plain(a) == plain(b)
    assert JAX_PCW_CFG == PCW_CFG


def _streams(jc, tc, frames, seeds):
    kw = dict(total_time=frames * 0.05, noise_px=0.25)
    return ([jax_stream(jc, seed=sd, **kw) for sd in seeds],
            [build_pcw_stream(tc, seed=sd, **kw) for sd in seeds])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pcw_stream_is_bit_equal(dtype):
    jc, tc = jax_cfg(dtype), torch_cfg(dtype)
    [(fj, gj)], [(ft, gt)] = _streams(jc, tc, 40, (3,))
    assert fj._fields == ft._fields
    for name, a, b in zip(fj._fields, fj, ft):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    assert sorted(gj) == sorted(gt)
    for k in gj:
        assert np.asarray(gj[k]).tobytes() == np.asarray(gt[k]).tobytes(), k


def _walk(a, b, path=""):
    """Yield (path, max |a - b|) over two numpy state trees."""
    if hasattr(a, "_fields"):
        for k in a._fields:
            yield from _walk(getattr(a, k), getattr(b, k), f"{path}.{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, path
        d = np.abs(a.astype(np.float64) - b.astype(np.float64))
        yield path, float(d.max()) if d.size else 0.0


@pytest.fixture(scope="module")
def runs():
    """Both packages' runs of FRAMES frames of two sequences from one
    initial state: (jax cfg, port cfg, jax (state, outs), port (state,
    outs))."""
    jc, tc = jax_cfg(), torch_cfg()
    jstreams, tstreams = _streams(jc, tc, FRAMES, SEEDS)
    g0 = np.stack([gt["gyro0"] for _, gt in jstreams])
    a0 = np.stack([gt["accel0"] for _, gt in jstreams])
    js = jax_batch_states(jc, len(SEEDS))
    js = js._replace(last_gyro=jnp.asarray(g0), last_accel=jnp.asarray(a0))
    jn = jax.tree.map(np.asarray, js)
    ts = interop.state_from_numpy(jn, "cpu")
    # the carried state goes back to the reference's exactly
    for path, d in _walk(interop.state_to_numpy(ts), jn):
        assert d == 0.0, path
    jfi = jax.tree.map(lambda *x: jnp.stack(x), *[f for f, _ in jstreams])
    tfi = type(tstreams[0][0])(*(np.stack(x) for x in
                                 zip(*[f for f, _ in tstreams])))
    return (jc, tc, jax_batch_runner(jc)(js, jfi),
            make_batch_runner(tc)(ts, tfi))


def test_vio_frame_matches_reference_over_20_frames(runs):
    _, _, (_, jo), (_, to) = runs
    assert jo._fields == to._fields
    for name in jo._fields:
        a, b = np.asarray(getattr(jo, name)), getattr(to, name).numpy()
        assert a.shape == b.shape == (len(SEEDS), FRAMES) + a.shape[2:]
        if np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-8,
                                       err_msg=name)
    # the run did real work: features and groups entered the state
    assert int(np.asarray(jo.num_instate_features)[:, -1].min()) > 0
    assert int(np.asarray(jo.num_instate_groups)[:, -1].min()) > 0


def test_final_state_matches_reference(runs):
    """Every leaf of the state after 20 frames, the factor included."""
    _, _, (js, _), (ts, _) = runs
    for path, d in _walk(interop.state_to_numpy(ts),
                         jax.tree.map(np.asarray, js)):
        assert d <= 1e-8, (path, d)


def test_update_blocks_match_reference_on_a_live_state(runs):
    """Stacked Jacobian, MH distances and gate, and error absorption on
    the state after 20 frames (features and groups in the state)."""
    from xivo_tpu.filter import update as ju
    from xivo_tpu_torch.filter import update as tu
    jc, tc, (js, _), (ts, _) = runs
    err = np.random.default_rng(5).standard_normal(
        (len(SEEDS), tc.dims.full)) * 1e-3

    @jax.jit
    @jax.vmap
    def reference(s, e):
        sj = ju.build_stacked_jacobian(jc, s)
        dist = ju.mh_distances(s.P, sj.H, sj.inn, jc.R)
        return (sj, dist, ju.mh_gate(jc, dist, sj.valid),
                ju.absorb_error(jc, s, e))

    jsj, jdist, jgate, jabs = jax.tree.map(np.asarray,
                                           reference(js, jnp.asarray(err)))
    sj = tu.build_stacked_jacobian(tc, ts)
    dist = tu.mh_distances(ts.P, sj.H, sj.inn, tc.R)
    assert int(sj.valid.sum()) > 0
    for name in ("H", "inn", "pred"):
        np.testing.assert_allclose(getattr(sj, name).numpy(),
                                   getattr(jsj, name), rtol=0, atol=1e-9,
                                   err_msg=name)
    np.testing.assert_array_equal(sj.valid.numpy(), jsj.valid)
    np.testing.assert_allclose(dist.numpy(), jdist, rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(tu.mh_gate(tc, dist, sj.valid).numpy(),
                                  jgate)
    absorbed = interop.state_to_numpy(
        tu.absorb_error(tc, ts, torch.tensor(err)))
    for path, d in _walk(absorbed, jabs):
        assert d <= 1e-12, (path, d)


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import xivo_tpu_torch, xivo_tpu_torch.runner, xivo_tpu_torch.interop\n"
        "import xivo_tpu_torch.sim.stream, xivo_tpu_torch.sim.configs\n"
        "import xivo_tpu_torch.ops.lanes_chol, xivo_tpu_torch.ops.lk\n"
        "import xivo_tpu_torch.frontend.tracker, xivo_tpu_torch.frontend.lk\n"
        "import xivo_tpu_torch.frontend.fast, xivo_tpu_torch.frontend.brief\n"
        "import xivo_tpu_torch.sim.render, xivo_tpu_torch.sim.image_stream\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'jaxlib' or m == 'xivo_tpu'\n"
        "       or m.startswith('xivo_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def test_entry_points_run_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    from xivo_tpu_torch.filter.state import init_state
    cfg = torch_cfg()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_state(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batch_states(cfg, 2)
    s = batch_states(cfg, 2, device="cpu")
    D = cfg.dims.full
    assert s.P.device.type == "cpu" and s.P.shape == (2, D, D + 3 * 8)


@pytest.mark.parametrize("option,item", [
    ("use_OOS", "A.15"), ("clone_frame_groups", "A.15"),
    ("use_fej", "A.15"), ("approximate_init_covariance", "A.15"),
    ("use_depth_opt", "A.16"), ("use_1pt_RANSAC", "A.16"),
    ("use_huber", "A.16"), ("use_oc", "A.16"),
    ("online_camera_calib", "A.16"), ("do_outlier_rejection", "A.12"),
    (("tracker_type", "MATCH"), "A.12"), (("detector", "GFTT"), "A.12"),
    (("descriptor_type", "orb"), "A.12"), (("cam_model", "equi"), "A.12")])
def test_options_outside_the_slice_raise(option, item):
    """Each branch the port leaves out names the ROADMAP.md item (queue
    A) that brings it, from every entry point."""
    from xivo_tpu_torch.filter.pipeline import vio_frame
    from xivo_tpu_torch.frontend.tracker import (tracker_only_frame,
                                                 vio_frame_image)
    name, value = option if isinstance(option, tuple) else (option, True)
    cfg = dataclasses.replace(torch_cfg(), **{name: value})
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        batch_states(cfg, 1, device="cpu")
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        vio_frame(cfg, None, *([None] * 8))
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        vio_frame_image(cfg, None, None, *([None] * 5))
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        tracker_only_frame(cfg, None, None, None)
