"""Trajectory evaluation and calibration analysis (port of
``xivo_tpu/eval``)."""
from .metrics import associate, horn_align, ate_rmse, rpe

__all__ = ["associate", "horn_align", "ate_rmse", "rpe"]
