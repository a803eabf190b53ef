"""Dataset loading and output writers (port of ``xivo_tpu/io``)."""
from .loader import (ImageMsg, IMUMsg, load_asl, load_dataset, load_image,
                     load_mocap_tumvi)
from .savers import StateDumpWriter, TrajectoryWriter

__all__ = ["ImageMsg", "IMUMsg", "load_asl", "load_dataset", "load_image",
           "load_mocap_tumvi", "StateDumpWriter", "TrajectoryWriter"]
