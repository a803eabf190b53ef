"""The card's published peaks and the least time a piece of work can take
on it (``chip_smoke.py``'s ``bound``, frozen).

NVIDIA's data sheet for the H100 SXM part, at its full power limit of
700 W: 3.35 TB/s of HBM3, 67 TFLOP/s in float32 outside the tensor
cores. A card set below 700 W runs slower under load; every run prints
the card's name and power limit beside its numbers.
"""
from __future__ import annotations

HBM_BYTES_S = 3.35e12     # H100 SXM device memory rate
F32_FLOPS = 67e12         # H100 SXM float32 peak outside the tensor cores
POWER_LIMIT_W = 700.0     # the limit the peaks above assume


def bound(n_bytes, n_flops):
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the operations over the float32 rate."""
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = n_flops / F32_FLOPS * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")
