"""A frozen plain-PyTorch copy of the VIO filter that the benchmark holds
the program against: the paths its configurations run (the point-cloud
tracker, fast propagation, the square-root update, the pinhole camera),
no more; ``filter/config.py`` refuses an option it does not carry.

The modules under ``filter/``, ``geom/``, ``cam/`` and ``ops/dense.py``
are copies of the program's own, taken when the benchmark was written,
so that a later change to the program is judged by the semantics it had
then. ``ops/`` keeps only the plain versions of the Cholesky kernels: no
CUDA source, no build, no launch counter. Everything runs in the dtype of its inputs on any device; the
benchmark runs it in float64. This package imports nothing of the
program.
"""
import torch


def resolve_device(device="cuda") -> torch.device:
    return torch.device(device)
