"""The plain reference of the point-cloud-world entry: the frozen
``vio_frame`` over the rows' inputs from fresh states."""
from __future__ import annotations

from ..gen.streams import PCW_FIELDS
from ..vioref.filter.pipeline import vio_frame
from . import common


def run(spec, fields, gyro0, accel0, dtype="float64", device="cuda",
        frames=None):
    """{compared field: (R, T, ...)} of the rows' sequences."""
    cfg = common.config(spec, dtype)
    s = common.states(cfg, gyro0, accel0, dtype, device)
    x = common.inputs(fields, dtype, device)
    T = frames or x["frame_dt"].shape[1]
    outs = []
    for t in range(T):
        s, out = vio_frame(cfg, s, *(x[f][:, t] for f in PCW_FIELDS))
        outs.append(out)
    return common.stacked(outs)
