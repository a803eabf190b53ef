"""The benchmark's frozen stream generators give the program's own
simulated streams bit for bit at the same seeds (at the tree the
benchmark was written at; a later change to the program's ``sim/``
shows here, not in the benchmark)."""
import numpy as np
import pytest

from portbench.gen import streams as gen
from portbench.harness import HERE, load_json


def _port_cfg(name):
    from portbench.entries import pcw
    spec = load_json(HERE, "configs", f"{name}.json")
    return spec, pcw.program_config(spec)


@pytest.mark.parametrize("world_seed", [0, 3141592653])
def test_pcw_stream_bit_for_bit(world_seed):
    from xivo_tpu_torch.sim.stream import build_pcw_stream
    spec, cfg = _port_cfg("pcw_sqrt")
    traffic = load_json(HERE, "traffic", "pcw_sqrt.montecarlo.json")
    kw = dict(traffic["generator"], noise_px=0.25, noise_accel=1e-4,
              noise_gyro=1e-5, world_seed=world_seed)
    fi, gt = build_pcw_stream(cfg, **kw)
    X = spec["filter"]["X"]
    mine, my_gt = gen.build_pcw_stream(spec["filter"]["camera_cfg"],
                                       X["Wbc"], X["Tbc"], **kw)
    for f in gen.PCW_FIELDS:
        a, b = getattr(fi, f), mine[f]
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for k in ("Rsb", "Tsb", "gyro0", "accel0"):
        assert np.array_equal(gt[k], my_gt[k]), k
