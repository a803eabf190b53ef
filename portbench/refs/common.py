"""Driving the frozen reference (``vioref``) over given rows: the
configuration built again from its file, fresh states, one frame at a
time. Nothing of the program is imported."""
from __future__ import annotations

import torch

from ..vioref.filter.config import config_from_json
from ..vioref.filter.layout import Dims
from ..vioref.filter.state import init_state, tree_map

# what the output check compares, frame by frame
COMPARED = ("Rsb", "Tsb")
DTYPES = {"float64": torch.float64, "float32": torch.float32}


def config(spec, dtype):
    dims = Dims(**spec["dims"]) if spec["dims"] else None
    opts = dict(spec["run_options"], dtype=dtype)
    return config_from_json(spec["filter"], dims=dims, **opts)


def states(cfg, gyro0, accel0, dtype, device):
    R = gyro0.shape[0]
    s = tree_map(lambda x: x.expand((R,) + x.shape).clone(),
                 init_state(cfg, device))
    return s._replace(last_gyro=gyro0.to(device, DTYPES[dtype]),
                      last_accel=accel0.to(device, DTYPES[dtype]))


def inputs(fields, dtype, device):
    """The rows' inputs in the reference's dtype: floating fields cast
    (float32 values are exact in float64), the rest as they are."""
    return {k: (v.to(device, DTYPES[dtype]) if v.is_floating_point()
                else v.to(device)) for k, v in fields.items()}


def stacked(outs):
    """{compared field: (R, T, ...) on the CPU} of per-frame outputs."""
    return {k: torch.stack([getattr(o, k) for o in outs], 1).cpu()
            for k in COMPARED}
