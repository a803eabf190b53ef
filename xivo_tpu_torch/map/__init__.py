"""Sparse map, loop closure and map-scale bundle adjustment (port of
``xivo_tpu/map``)."""
