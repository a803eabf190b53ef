"""The pyxivo surface of the port (port of ``xivo_tpu/api``)."""
from .estimator import Estimator
from .process import EstimatorProcess

__all__ = ["Estimator", "EstimatorProcess"]
