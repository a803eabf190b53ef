"""Error-state layout (a copy of ``xivo_tpu/filter/layout.py``).

TPU-first redesign of the reference's compile-time layout
(``src/core.h:40-105``): every calibration block — temporal offset td,
gyro intrinsics Cg (9), accel intrinsics Ca (6), camera intrinsics (9) —
is ALWAYS present in the error state. A calibration state that a config
disables simply gets zero initial covariance and zero process noise: a
zero row/column of P is invariant under propagation and Joseph updates,
so the entry stays frozen — the same mechanism the reference uses for
gauge fixing (``src/estimator.cpp:1382-1389``). One static shape thus
serves every configuration, which is what XLA wants.

Offsets (motion part)::

    Wsb 0  Tsb 3  Vsb 6  bg 9  ba 12  Wbc 15  Tbc 18  Wsg 21 (2-dim)
    td 23  Cg 24 (9)  Ca 33 (6)       -> MOTION = 39
    camera intrinsics 39 (9)          -> GROUP_BEGIN = 48
    groups  48 + 6*sind    (sind in [0, n_groups))
    features GROUP_BEGIN + 6*n_groups + 3*sind
"""
from __future__ import annotations

from typing import NamedTuple

# motion-block offsets
WSB = 0
TSB = 3
VSB = 6
BG = 9
BA = 12
WBC = 15
TBC = 18
WSG = 21  # 2-dim: z-rotation of gravity frame unobservable (src/core.h:35-39)
TD = 23
CG = 24   # 9
CA = 33   # 6
MOTION = 39
CAM = MOTION          # 9 camera-intrinsics entries
NCAM = 9
GROUP_BEGIN = CAM + NCAM  # 48


class Dims(NamedTuple):
    """Static capacities; hashable so it can be a jit static argument.

    n_groups/n_features are the EKF window sizes (kMaxGroup/kMaxFeature,
    ``src/core.h:90-101``); ng_rows/nf_rows are the graph capacities
    (the MemoryManager pool sizes, ``src/mm.cpp``).
    """
    n_groups: int = 15     # instate group slots (kMaxGroup)
    n_features: int = 30   # instate feature slots (kMaxFeature)
    # graph capacities. ng_rows must absorb worst-case reference pinning:
    # every live track pins its creation-frame group row, so size it
    # relative to nf_rows (cf. MemoryManager pools, src/mm.cpp; cfg
    # "memory.max_groups")
    ng_rows: int = 128     # group-table rows (graph capacity)
    nf_rows: int = 256     # feature/track-table rows (graph capacity)

    @property
    def feature_begin(self) -> int:
        return GROUP_BEGIN + 6 * self.n_groups

    @property
    def full(self) -> int:
        return self.feature_begin + 3 * self.n_features
