"""The port's image-mode frame step against the JAX package, on the CPU.

* ``build_image_stream`` renders and packs a stream bit-equal to the
  reference's recipe (``scripts/bench_image.py::build_frames``, rebuilt
  here from ``xivo_tpu.sim.render.render_dots`` and ``get_imu_sim``);
* ``vio_frame_image``: 12 frames of two rendered sequences (IMG_CFG's
  320 x 240 pinhole camera, tiny Dims, float64, B = 2) from one initial
  state carried across with ``interop``. IMG_CFG's admission gate
  (``max_depth_var_for_admission`` 0.01) admits no feature in 30 frames
  at these Dims, so the default gate is kept: features enter the state
  from frame 3 and the filter update runs on image tracks.

The reference crops patches with one-hot selection matmuls, and on
float32 images (the tracker's, whatever the filter's dtype) it runs them
in bfloat16 (``frontend/image.py:18-42``), which rounds intensities by
up to half a grey level. The port crops exactly, by indexing. For the
comparison the reference's run takes the exact form of the same matmuls,
the one it uses for float64 (``precision=HIGHEST``); nothing in the JAX
package changes for that.

Tolerances. Integer outputs, descriptor words, feature ids and track
states exactly. The reference runs the tracker on float32 images even in
x64 mode (``frontend/tracker.py:77`` casts the image), so LK's window
sums are float32 sums, and the two packages take them in another order:
track positions differ by up to 4.1e-7 px, which the filter carries into
poses, velocities and innovation RMS at up to 5.2e-8 (measured on both
runs). They are held within 5e-6 px and 5e-7, about ten times that; the
float32 pyramids (the same stencils in the same order) exactly.

The case with prediction, the descriptor gate and the dropped-track
rescue is ``tests/test_torch_image_prediction.py`` (its own file, so
that the test workers take the two runs in parallel).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xivo_tpu.filter.config import config_from_json as jax_config_from_json
from xivo_tpu.filter.layout import Dims as JaxDims
from xivo_tpu.frontend import init_frontend as jax_init_frontend
from xivo_tpu.frontend import image as jax_image
from xivo_tpu.frontend import vio_frame_image as jax_vio_frame_image
from xivo_tpu.geom import so3 as jso3
from xivo_tpu.ops.dense import HIGHEST
from xivo_tpu.runner import batch_states as jax_batch_states
from xivo_tpu.sim import get_imu_sim as jax_get_imu_sim
from xivo_tpu.sim.configs import IMG_CFG as JAX_IMG_CFG
from xivo_tpu.sim.configs import make_world as jax_make_world
from xivo_tpu.sim.render import render_dots as jax_render_dots
from xivo_tpu_torch import interop
from xivo_tpu_torch.filter.config import config_from_json
from xivo_tpu_torch.filter.layout import Dims
from xivo_tpu_torch.runner import (batch_frontend_states, batch_states,
                                   fit_substeps, image_inputs_to_device,
                                   run_batch_image)
from xivo_tpu_torch.sim.configs import IMG_CFG
from xivo_tpu_torch.sim.image_stream import build_image_stream

from test_torch_homography import tracker_draws

torch.set_num_threads(2)
TINY = (4, 8, 16, 32)        # n_groups, n_features, ng_rows, nf_rows
FRAMES = 12
SEEDS = (1, 2)
STREAM = dict(n_points=500, world_seed=0, imu_T=3.0)
POS_TOL, POSE_TOL = 5e-6, 5e-7


def image_cfgs(dtype="float64", raw=None, modes=None, **tracker):
    """(reference config, port config): IMG_CFG, or the config dict `raw`,
    at tiny Dims with the default admission gate, tracker_cfg overridden
    by ``tracker``; `modes` are ``config_from_json``'s overrides (by
    default fast propagation and the square-root form)."""
    if modes is None:
        modes = dict(propagation_mode="fast", covariance_form="sqrt")

    def build(base, from_json, dims):
        raw = dict(base)
        raw.pop("max_depth_var_for_admission")
        raw["tracker_cfg"] = dict(raw["tracker_cfg"], **tracker)
        return from_json(raw, dims=dims(*TINY), dtype=dtype, **modes)
    return (build(raw or JAX_IMG_CFG, jax_config_from_json, JaxDims),
            build(raw or IMG_CFG, config_from_json, Dims))


def reference_stream(jc, frames, seed, n_points, world_seed, imu_T,
                     vis_dt=0.05, imu_dt=0.01, KI=8):
    """The reference's image stream recipe (``bench_image.build_frames``)
    for the config's pinhole camera, in the config's float dtype."""
    imu = jax_get_imu_sim("gentle", T=imu_T, noise_accel=1e-4,
                          noise_gyro=1e-5, seed=seed)
    Xs = jax_make_world(n_points, seed=world_seed)
    rows, cols = int(jc.cam_params[0]), int(jc.cam_params[1])
    fx, fy, cx, cy = jc.cam_params[2:6]
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    Rbc = np.asarray(jso3.exp(jnp.asarray(jc.X_Wbc)))
    Tbc = np.asarray(jc.X_Tbc)
    dt = np.float32 if jc.dtype == "float32" else np.float64
    out = {k: [] for k in ("gyro", "accel", "imu_dt", "frame_dt", "image",
                           "Rsb", "Tsb")}
    t_prev, t = 0.0, vis_dt
    for _ in range(frames):
        gys, acs, dts = (np.zeros((KI, 3), dt), np.zeros((KI, 3), dt),
                         np.zeros((KI,), dt))
        i, ti = 0, t_prev + imu_dt
        while ti <= t + 1e-9 and i < KI:
            a, g = imu.meas(ti)
            gys[i], acs[i], dts[i] = g, a, imu_dt
            ti += imu_dt
            i += 1
        Rsb, Tsb = imu.gsb(t)
        for k, v in (("gyro", gys), ("accel", acs), ("imu_dt", dts),
                     ("frame_dt", max(t - t_prev - imu_dt * i, 0.0)),
                     ("image", jax_render_dots(Xs, Rsb @ Rbc, Rsb @ Tbc + Tsb,
                                               K, cols, rows)),
                     ("Rsb", Rsb), ("Tsb", Tsb)):
            out[k].append(v)
        t_prev, t = t, t + vis_dt
    out = {k: np.asarray(v) for k, v in out.items()}
    out["frame_dt"] = out["frame_dt"].astype(dt)
    a0, g0 = imu.meas(0.0)
    return out, g0, a0


def port_stream(tc, frames, seed):
    return build_image_stream(tc, total_time=0.05 * (frames + 1) - 0.01,
                              seed=seed, **STREAM)


@contextlib.contextmanager
def exact_crops():
    """The reference's selection matmuls in their exact form (see the
    module docstring), while the block runs."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_image, "sel_matmul", lambda A, B: jnp.matmul(
            A, B, precision=HIGHEST))
        mp.setattr(jax_image, "sel_einsum", lambda spec, A, B: jnp.einsum(
            spec, A, B, precision=HIGHEST))
        yield


def run_both(jc, tc, frames=FRAMES, seeds=SEEDS, edit=None):
    """Both packages' runs of `frames` frames of len(seeds) sequences
    from one initial state: (reference (state, front end, outputs
    stacked (B, T, ...)), port (state, front end, outputs)); `edit` maps
    the stacked stream's images (B, T, H, W) to those both run on. The
    reference's ``next_fid`` (and, with ``do_outlier_rejection``, its
    rejection count) starts as int64, the dtype JAX's sums give it after
    a frame with x64 on, so that its step is traced once. With
    ``do_outlier_rejection``, each sequence gets its own key, and the
    homography draws the reference makes from it each frame are rebuilt
    (``tracker_draws``) and handed to the port."""
    streams = [port_stream(tc, frames, sd) for sd in seeds]
    fi = type(streams[0][0])(*(np.stack(x) for x in
                               zip(*[f for f, _ in streams])))
    if edit is not None:
        fi = fi._replace(image=edit(fi.image))
    g0 = np.stack([gt["gyro0"] for _, gt in streams])
    a0 = np.stack([gt["accel0"] for _, gt in streams])
    B = len(seeds)
    js = jax_batch_states(jc, B)._replace(last_gyro=jnp.asarray(g0),
                                          last_accel=jnp.asarray(a0))
    jf = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape).copy(),
                      jax_init_frontend(jc))
    js = js._replace(next_fid=js.next_fid.astype(jnp.int64))
    rejection = jc.do_outlier_rejection
    if rejection:
        js = js._replace(key=jax.random.split(jax.random.PRNGKey(9), B),
                         n_tracker_rejected=js.n_tracker_rejected.astype(
                             jnp.int64))
    ts = interop.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    tf = interop.frontend_from_numpy(jax.tree.map(np.asarray, jf), "cpu")

    step = jax.jit(jax.vmap(
        lambda s, f, *a: jax_vio_frame_image(jc, s, f, *a)))
    outs, draws = [], []
    with exact_crops():
        for t in range(frames):
            if rejection:
                nxt, u = tracker_draws(js.key, jc.dims.nf_rows)
                draws.append(u)
            js, jf, o = step(js, jf, *(jnp.asarray(a[:, t]) for a in fi))
            if rejection:
                np.testing.assert_array_equal(np.asarray(js.key),
                                              np.asarray(nxt))
            outs.append(o)
    jo = jax.tree.map(lambda *x: np.stack(x, 1), *outs)
    ref = (jax.tree.map(np.asarray, js), jax.tree.map(np.asarray, jf), jo)
    hom = torch.tensor(np.stack(draws, 1)) if rejection else None
    port = run_batch_image(fit_substeps(tc, fi), ts, tf,
                           image_inputs_to_device(fi, "cpu"),
                           hom_uniforms=hom)
    return ref, port


def check_outputs(jo, to, frames=FRAMES, seeds=SEEDS):
    assert jo._fields == to._fields
    for name in jo._fields:
        a, b = np.asarray(getattr(jo, name)), getattr(to, name).numpy()
        assert a.shape == b.shape == (len(seeds), frames) + a.shape[2:]
        if np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=POSE_TOL,
                                       err_msg=name)


def check_tables(js, ts, jf, tf):
    """The track table and the front end's pyramid after the run."""
    tn = interop.state_to_numpy(ts)
    jfr, tfr = js.features, tn.features
    for name in jfr._fields:
        a, b = np.asarray(getattr(jfr, name)), np.asarray(getattr(tfr, name))
        assert a.shape == b.shape, name
        if np.issubdtype(a.dtype, np.integer) or a.dtype == bool:
            np.testing.assert_array_equal(b, a, err_msg=name)
    np.testing.assert_allclose(tfr.xp, jfr.xp, rtol=0, atol=POS_TOL)
    assert int(tn.next_fid.min()) == int(np.asarray(js.next_fid).min())
    tfn = interop.frontend_to_numpy(tf)
    for a, b in zip(jf.pyr, tfn.pyr):
        assert a.shape == b.shape and b.dtype == np.float32
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(tfn.initialized, jf.initialized)


@pytest.fixture(scope="module")
def runs():
    return run_both(*image_cfgs())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_image_stream_is_bit_equal(dtype):
    jc, tc = image_cfgs(dtype)
    fi, gt = port_stream(tc, 6, 3)
    ref, g0, a0 = reference_stream(jc, 6, 3, **STREAM)
    for name in fi._fields:
        a, b = ref[name], getattr(fi, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    assert fi.image.shape == (6, 240, 320) and fi.image.dtype == np.float32
    for k in ("Rsb", "Tsb"):
        assert ref[k].tobytes() == gt[k].tobytes(), k
    assert np.asarray(g0).tobytes() == gt["gyro0"].tobytes()
    assert np.asarray(a0).tobytes() == gt["accel0"].tobytes()


def test_vio_frame_image_matches_reference_over_12_frames(runs):
    (_, _, jo), (_, _, to) = runs
    check_outputs(jo, to)
    # the run did real work: tracks held, features entered the state
    assert int(jo.num_tracked[:, 1:].min()) > 0
    assert int(jo.num_instate_features[:, -1].min()) > 0


def test_track_table_and_pyramid_match_reference(runs):
    (js, jf, _), (ts, tf, _) = runs
    check_tables(js, ts, jf, tf)


def test_image_bench_config_matches_reference():
    """IMG_BENCH_CFG is ``bench_image.build_frames``'s pinhole config
    (rebuilt here: importing that script sets JAX's global matmul
    precision)."""
    from test_torch_pipeline import plain
    from xivo_tpu_torch.sim.configs import IMG_BENCH_CFG, IMG_BENCH_DIMS
    raw = dict(JAX_IMG_CFG)
    raw["camera_cfg"] = {"model": "pinhole", "rows": 512, "cols": 512,
                         "fx": 191.0, "fy": 191.0, "cx": 256.0, "cy": 256.0}
    raw["tracker_cfg"] = dict(
        JAX_IMG_CFG["tracker_cfg"],
        KLT={"win_size": 15, "max_level": 4, "max_iter": 15, "eps": 0.01})
    a = jax_config_from_json(raw, dtype="float32", propagation_mode="fast",
                             dims=JaxDims(nf_rows=128, ng_rows=64))
    b = config_from_json(IMG_BENCH_CFG, dtype="float32",
                         propagation_mode="fast", dims=Dims(**IMG_BENCH_DIMS))
    assert plain(a) == plain(b)
    assert b.dims.full == 228 and b.klt_max_level == 4


def test_image_entry_points_run_on_cuda_unless_asked_for_the_cpu(
        monkeypatch):
    from xivo_tpu_torch.frontend.tracker import init_frontend
    _, tc = image_cfgs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_frontend(tc)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batch_frontend_states(tc, 2)
    fes = batch_frontend_states(tc, 2, device="cpu")
    assert [tuple(p.shape) for p in fes.pyr] == [(2, 240, 320),
                                                 (2, 120, 160),
                                                 (2, 60, 80)]
    assert fes.initialized.shape == (2,) and not bool(fes.initialized.any())


def test_stream_broadcast_to_the_batch_is_a_view():
    _, tc = image_cfgs("float32")
    fi, _ = port_stream(tc, 3, 1)
    dev = image_inputs_to_device(fi, "cpu", batch=16)
    assert dev.image.shape == (16, 3, 240, 320)
    assert dev.image.stride(0) == 0
    assert dev.image.untyped_storage().nbytes() == fi.image.nbytes

