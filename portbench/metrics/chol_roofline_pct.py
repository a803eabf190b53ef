"""``chol_roofline_pct``: the Cholesky family's share of its roofline.
The calls of ``ops.lanes_chol.chol_lanes`` (B1), ``chol_inv_lanes`` (B2)
and ``tri_inv_lanes`` (B3), each on (B, m, m): each reads the lower
triangle of its input and writes whole (m, m) outputs (one, or two for
B2), and does m^3 / 3 flops a matrix an output, over the card's peaks
(``peaks.bound``)."""
from __future__ import annotations

from ..peaks import bound
from ._roofline import share_pct

N_OUT = {"chol_lanes": 1, "chol_inv_lanes": 2, "tri_inv_lanes": 1}
RANGES = [f"xivo_tpu_torch.ops.lanes_chol:{n}" for n in N_OUT]


def work(name, batch, m):
    """(bytes, flops) of one call on (batch, m, m)."""
    n = N_OUT[name]
    return (batch * (m * (m + 1) // 2 + n * m * m) * 4,
            n * batch * m ** 3 / 3.0)


def least_ms(path, args):
    batch, m, _ = args[0]
    return bound(*work(path.split(":")[1], batch, m))[0]


def read(ctx):
    return share_pct(ctx, RANGES, least_ms)
