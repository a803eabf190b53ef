"""``ops/imu_chain`` on the CPU: the wrapper's rows against the offsets of
``csrc/imu_chain.cu``, its constants, the checks it makes before a
launch, and its CPU path (the plain version, under the ``imu_slots`` and
``visual_segment`` spans), with the pipeline's OC correction after it.
The kernel itself runs on the card only
(``tests/test_torch_cuda.py``); the plain version is held against the JAX
package by ``tests/test_torch_propagate_features.py`` and the pipeline
tests."""
import dataclasses
import os
import re

import pytest
import torch

from chip_smoke import chain_config, imu_chain_inputs
from xivo_tpu_torch import tracing
from xivo_tpu_torch.filter.pipeline import _propagate_frame_fast
from xivo_tpu_torch.ops import _build
from xivo_tpu_torch.ops import imu_chain as ic
from xivo_tpu_torch.runner import batch_states

SOURCE = os.path.join(_build.CSRC, "imu_chain.cu")


def cu_offsets(prefix):
    """{name: value} of the source's ``constexpr int <prefix>_...``."""
    with open(SOURCE) as f:
        text = f.read()
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        rf"\b({prefix}_[A-Z]+) = (\d+)", text)}


def inputs(B=3, KI=4, dtype=torch.float64):
    return imu_chain_inputs(torch, B, KI, dtype, seed=B + KI, device="cpu")


def test_the_rows_match_the_kernels_offsets():
    widths = [9 if f[0] in "RC" else 3 for f in ic.IN_FIELDS] \
        + [3, 3, 3, 3, 1]
    names = ["IN_R", "IN_T", "IN_V", "IN_BG", "IN_BA", "IN_RSG", "IN_CG",
             "IN_CA", "IN_LG", "IN_LA", "IN_SG", "IN_SA", "IN_DTE", "N_IN"]
    starts = [sum(widths[:i]) for i in range(len(widths) + 1)]
    cu = cu_offsets("IN") | cu_offsets("N")
    assert {k: cu[k] for k in names} == dict(zip(names, starts))
    names = ["OUT_R", "OUT_T", "OUT_V", "OUT_LG", "OUT_LA", "OUT_SG",
             "OUT_SA", "N_OUT"]
    starts = [sum(ic.OUT_WIDTHS[:i]) for i in range(len(ic.OUT_WIDTHS) + 1)]
    cu = cu_offsets("OUT") | cu_offsets("N")
    assert {k: cu[k] for k in names} == dict(zip(names, starts))


def test_the_constants_are_the_configs():
    cfg = chain_config()
    c = ic.constants(cfg)
    assert len(c) == 18
    assert c[:3] == tuple(cfg.gravity)
    assert c[3:15] == tuple(cfg.Qimu_gyro) + tuple(cfg.Qimu_accel) \
        + tuple(cfg.Qimu_gyro_bias) + tuple(cfg.Qimu_accel_bias)
    assert c[15:] == (cfg.stepsize, 1e-12, 1e-8)


def test_the_checks_pass_good_inputs_and_refuse_the_rest():
    cfg = chain_config()
    X, lg, la, sg, sa, gy, ac, dt, dte = inputs()
    head = (X, lg, la, sg, sa)
    ic._check_inputs(cfg, *head, gy, ac, dt, dte)
    ic._check_inputs(cfg, *inputs(dtype=torch.float32))
    ic._check_inputs(cfg, *head, gy[:, :1], ac[:, :1], dt[:, :1], dte)
    # a slot of the stream packed (B, T, KI, ...) is a strided view
    ic._check_inputs(cfg, *head, torch.stack([gy, gy], 1)[:, 1], ac, dt,
                     dte)
    with pytest.raises(TypeError):
        ic._check_inputs(cfg, type(X)(*(v.half() for v in X)), *(
            v.half() for v in (lg, la, sg, sa, gy, ac, dt, dte)))
    with pytest.raises(TypeError):
        ic._check_inputs(cfg, *head, gy, ac, dt, dte.float())
    with pytest.raises(ValueError):
        ic._check_inputs(cfg, *head, gy, ac, torch.cat([dt, dt], 1), dte)
    with pytest.raises(ValueError):
        ic._check_inputs(cfg, X._replace(Rsg=X.Rsg[:, 0]), lg, la, sg, sa,
                         gy, ac, dt, dte)
    with pytest.raises(ValueError):
        ic._check_inputs(cfg, *head, gy, ac, dt, dte[:2])
    with pytest.raises(ValueError):
        ic._check_inputs(dataclasses.replace(cfg, fast_substeps=0), *head,
                         gy, ac, dt, dte)
    with pytest.raises(ValueError):
        ic._check_inputs(cfg, type(X)(*(v[:0] for v in X)), *(
            v[:0] for v in (lg, la, sg, sa, gy, ac, dt, dte)))


@pytest.mark.parametrize("oc", [False, True])
def test_the_cpu_path_is_the_plain_version_under_its_spans(oc):
    """On the CPU ``imu_chain`` is ``chain_plain`` under the ``imu_slots``
    and ``visual_segment`` spans and launches nothing. In the pipeline's
    fast propagation, ``use_oc`` corrects Phi after the chain under a
    ``visual_segment`` span of its own and keeps the chain's pose as the
    next frame's OC prior."""
    cfg = dataclasses.replace(chain_config(), dtype="float64", use_oc=oc)
    args = inputs()
    X, lg, la, sg, sa, gy, ac, dt, dte = args
    s = batch_states(cfg, 3, "cpu")
    s = s._replace(X=X, last_gyro=lg, last_accel=la, slope_gyro=sg,
                   slope_accel=sa, oc_R=X.Rsb.flip(1), oc_V=X.Vsb + 1.0,
                   oc_T=X.Tsb + 1.0)
    kept = (tracing.IMU_SLOTS, tracing.VISUAL_SEGMENT, tracing.COV_PROPAGATE)
    tracing.clear()
    tracing.enable()
    try:
        got = ic.imu_chain(cfg, *args)
        chain_names = [r.name for r in tracing.records() if r.name in kept]
        tracing.clear()
        s1 = _propagate_frame_fast(cfg, s, gy, ac, dt, dte)
        frame_names = [r.name for r in tracing.records() if r.name in kept]
    finally:
        tracing.disable()
        tracing.clear()
    assert chain_names == [tracing.IMU_SLOTS, tracing.VISUAL_SEGMENT]
    assert frame_names == chain_names + [tracing.VISUAL_SEGMENT] * oc \
        + [tracing.COV_PROPAGATE]
    n = ic.CHAIN.launches
    want = ic.chain_plain(cfg, *args)
    assert ic.CHAIN.launches == n
    flat = [*got[0], *got[1:]], [*want[0], *want[1:]]
    assert all(torch.equal(a, b) for a, b in zip(*flat))
    assert int(want[7].min()) >= 1     # rows 0 and 1 propagate
    assert want[7].tolist()[2] == int(args[8][2] > 0)   # row 2 all padded
    Xw = want[0]
    assert torch.equal(s1.X.Tsb, Xw.Tsb) and torch.equal(s1.X.Vsb, Xw.Vsb)
    prior = (Xw.Rsb, Xw.Vsb, Xw.Tsb) if oc else (s.oc_R, s.oc_V, s.oc_T)
    assert all(torch.equal(a, b) for a, b in zip(
        (s1.oc_R, s1.oc_V, s1.oc_T), prior))
