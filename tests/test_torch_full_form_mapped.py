"""The mapped frame step on the reference's default filter (reference
propagation, dense covariance: the mapper's dense MH gate in
``close_loop``, whose update is then a Joseph update, and the dense
feature blocks in ``retire_features``) against the JAX package, float64
on the CPU: ``test_torch_mapped_pipeline.py``'s run (its mapper settings but
closures eligible after 12 frames, draws rebuilt from the reference's key,
checks and tolerances) over 24 frames, with ``propagation_mode`` and
``covariance_form`` left at the config's defaults."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_mapped_pipeline import (CAPACITY, MAPPER, SEEDS, STREAM,
                                        batched_map, check_maps,
                                        check_outputs, run_reference)
from test_torch_pipeline import TINY
from xivo_tpu.filter.config import config_from_json as jax_config_from_json
from xivo_tpu.filter.layout import Dims as JaxDims
from xivo_tpu.map.integration import vio_frame_mapped as jax_vio_frame_mapped
from xivo_tpu.runner import batch_states as jax_batch_states
from xivo_tpu.sim.configs import PCW_CFG as JAX_PCW_CFG
from xivo_tpu.sim.stream import build_pcw_stream as jax_stream
from xivo_tpu_torch import interop
from xivo_tpu_torch.filter.config import config_from_json
from xivo_tpu_torch.filter.layout import Dims
from xivo_tpu_torch.runner import (fit_substeps, inputs_to_device,
                                   run_batch_mapped)
from xivo_tpu_torch.sim.configs import PCW_CFG

torch.set_num_threads(2)
FRAMES = 24
# closures eligible after 12 frames, so that they fire within the run
MAPPED = dict(MAPPER, lc_min_age_frames=12)


def test_default_filter_mapped_frames_match_reference():
    jc = jax_config_from_json(JAX_PCW_CFG, dims=JaxDims(*TINY),
                              dtype="float64", **MAPPED)
    tc = config_from_json(PCW_CFG, dims=Dims(*TINY), dtype="float64",
                          **MAPPED)
    assert (tc.propagation_mode, tc.covariance_form) == ("reference", "full")
    kw = dict(total_time=FRAMES * 0.05, **STREAM)
    streams = [jax_stream(jc, seed=sd, **kw) for sd in SEEDS]
    fi = type(streams[0][0])(*(np.stack(x)[:, :FRAMES] for x in
                               zip(*[f for f, _ in streams])))
    B = len(SEEDS)
    js = jax_batch_states(jc, B)._replace(
        last_gyro=jnp.asarray(np.stack([g["gyro0"] for _, g in streams])),
        last_accel=jnp.asarray(np.stack([g["accel0"] for _, g in streams])))
    jms = batched_map(CAPACITY, B)
    ts = interop.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    tms = interop.map_from_numpy(jax.tree.map(np.asarray, jms), "cpu")
    vstep = jax.jit(jax.vmap(lambda s, ms, *a: jax_vio_frame_mapped(
        jc, s, ms, *a)))
    jfi = jax.tree.map(jnp.asarray, tuple(fi))
    js, jms, jo, jlc, draws = run_reference(
        lambda s, ms, t: vstep(s, ms, *(a[:, t] for a in jfi)), js, jms,
        FRAMES, jc.dims.n_features)
    ts, tms, to, tlc = run_batch_mapped(
        fit_substeps(tc, fi), ts, tms, inputs_to_device(fi, "cpu"),
        uniforms=torch.from_numpy(draws))
    np.testing.assert_array_equal(tlc.numpy(), jlc)
    check_outputs(jo, to)
    check_maps(jms, tms)
    assert int(jlc.sum()) > 0, jlc.sum(1)
    assert ts.P.shape[-1] == ts.P.shape[-2]
    P, Pj = ts.P.numpy(), np.asarray(js.P)
    assert np.abs(P - Pj).max() <= 1e-7 * np.abs(Pj).max()
    np.testing.assert_array_equal((P == 0).all(-1), (Pj == 0).all(-1))
