"""Filter state and initialization (port of ``xivo_tpu/filter/state.py``).

Same fixed-capacity masked tables as the reference. Differences:

* index and count fields are int64 (the reference uses int32);
* ``FeatureTable.desc`` holds the 32-bit descriptor words in int64;
* no PRNG key: the reference draws from ``s.key`` for the homography
  RANSAC of the trackers and for the P3P RANSAC of loop closure
  (``map/mapper.py:237``); the port's frame steps take those draws as an
  argument instead, which the runners make with a seeded
  ``torch.Generator`` (``runner.frame_draws``).

The filter functions take every field with a leading batch axis B
(``runner.batch_states``); ``init_state`` builds one unbatched sequence.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..cam import models as cam_mod
from ..geom import so3
from . import layout
from .config import VIOConfig

# feature status codes (cf. FeatureStatus, src/core.h:190-199)
FS_EMPTY = 0
FS_CREATED = 1
FS_INITIALIZING = 2
FS_READY = 3
FS_INSTATE = 4
FS_GAUGE = 5

# track status codes (cf. TrackStatus, src/core.h:185-189)
TS_NONE = 0
TS_CREATED = 1
TS_TRACKED = 2
TS_DROPPED = 3


class MotionState(NamedTuple):
    """Nominal motion + calibration state (cf. State, src/core.h:117-180)."""
    Rsb: torch.Tensor   # (B,3,3) body -> spatial
    Tsb: torch.Tensor   # (B,3)
    Vsb: torch.Tensor   # (B,3)
    bg: torch.Tensor    # (B,3)
    ba: torch.Tensor    # (B,3)
    Rbc: torch.Tensor   # (B,3,3) camera -> body
    Tbc: torch.Tensor   # (B,3)
    Rsg: torch.Tensor   # (B,3,3) gravity -> spatial
    td: torch.Tensor    # (B,) temporal offset
    Cg: torch.Tensor    # (B,3,3) gyro intrinsics
    Ca: torch.Tensor    # (B,3,3) accel intrinsics (upper-triangular)


class GroupTable(NamedTuple):
    gid: torch.Tensor       # (B,NG) int64, -1 = empty row
    Rsb: torch.Tensor       # (B,NG,3,3)
    Tsb: torch.Tensor       # (B,NG,3)
    lifetime: torch.Tensor  # (B,NG) int64
    sind: torch.Tensor      # (B,NG) int64, EKF slot or -1
    Rsb_fej: torch.Tensor   # (B,NG,3,3) first-estimate pose
    Tsb_fej: torch.Tensor   # (B,NG,3)
    is_clone: torch.Tensor  # (B,NG) bool, pure pose clone (cloning configs)

    @property
    def active(self):
        return self.gid >= 0

    @property
    def instate(self):
        return self.sind >= 0


class FeatureTable(NamedTuple):
    fid: torch.Tensor        # (B,NF) int64, -1 = empty row
    status: torch.Tensor     # (B,NF) FS_*
    track: torch.Tensor      # (B,NF) TS_*
    ref: torch.Tensor        # (B,NF) group-table ROW index, -1
    x: torch.Tensor          # (B,NF,3) (X/Z, Y/Z, log Z) in the ref camera
    Psub: torch.Tensor       # (B,NF,3,3) subfilter covariance
    sind: torch.Tensor       # (B,NF) EKF slot or -1
    init_counter: torch.Tensor     # (B,NF)
    lifetime: torch.Tensor         # (B,NF)
    outlier_counter: torch.Tensor  # (B,NF) float
    xp: torch.Tensor         # (B,NF,2) latest pixel measurement
    pred: torch.Tensor       # (B,NF,2) predicted pixel
    tri_ok: torch.Tensor     # (B,NF) bool
    adj: torch.Tensor        # (B,NF,NG) bool visibility adjacency
    adj_xp: torch.Tensor     # (B,NF,NG,2) pixel per (feature, group)
    sim_depth: torch.Tensor  # (B,NF) ground-truth depth hint (simulation)
    desc: torch.Tensor       # (B,NF,8) 32-bit descriptor words in int64
    x_fej: torch.Tensor      # (B,NF,3) first estimate of x

    @property
    def active(self):
        return self.fid >= 0

    @property
    def instate(self):
        return self.sind >= 0


class VIOState(NamedTuple):
    X: MotionState
    cam: torch.Tensor        # (B,9) camera intrinsics estimate
    P: torch.Tensor          # (B,D,D) covariance, or (B,D,D+3F) factor S
    #                          with P = S S^T (covariance_form "sqrt")
    features: FeatureTable
    groups: GroupTable
    g2row: torch.Tensor      # (B,n_groups) EKF slot -> group row, -1 free
    f2row: torch.Tensor      # (B,n_features) EKF slot -> feature row, -1 free
    gauge_row: torch.Tensor  # (B,) group row of the gauge group, -1
    init_z: torch.Tensor     # (B,) adaptive initial depth
    last_gyro: torch.Tensor  # (B,3)
    last_accel: torch.Tensor
    slope_gyro: torch.Tensor
    slope_accel: torch.Tensor
    td_applied: torch.Tensor      # (B,)
    vision_counter: torch.Tensor  # (B,)
    next_gid: torch.Tensor        # (B,)
    next_fid: torch.Tensor        # (B,)
    oc_R: torch.Tensor            # (B,3,3) OC-EKF prior chain (use_oc)
    oc_V: torch.Tensor            # (B,3)
    oc_T: torch.Tensor            # (B,3)
    n_tracker_rejected: torch.Tensor  # (B,)


def torch_dtype(cfg: VIOConfig) -> torch.dtype:
    return {"float32": torch.float32, "float64": torch.float64}[cfg.dtype]


def init_state(cfg: VIOConfig, device="cuda") -> VIOState:
    """Initial state of ONE sequence (no batch axis); Estimator ctor parity.
    ``runner.batch_states`` stacks B of these for the filter."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg)
    d = cfg.dims
    D = d.full

    def t(v):
        return torch.tensor(v, dtype=dt, device=dev)

    X = MotionState(
        Rsb=so3.exp(t(cfg.X_Wsb)),
        Tsb=t(cfg.X_Tsb), Vsb=t(cfg.X_Vsb), bg=t(cfg.X_bg), ba=t(cfg.X_ba),
        Rbc=so3.exp(t(cfg.X_Wbc)), Tbc=t(cfg.X_Tbc),
        Rsg=so3.exp(t(tuple(cfg.X_Wsg) + (0.0,))),
        td=t(cfg.X_td),
        Cg=t(cfg.Cg).reshape(3, 3), Ca=t(cfg.Ca).reshape(3, 3))
    if cfg.imu_tk_convention:
        X = X._replace(bg=-X.Cg @ X.bg, ba=-X.Ca @ X.ba)

    stds = np.zeros(D)
    stds[layout.WSB:layout.WSB + 3] = cfg.P_Wsb
    stds[layout.TSB:layout.TSB + 3] = cfg.P_Tsb
    stds[layout.VSB:layout.VSB + 3] = cfg.P_Vsb
    stds[layout.BG:layout.BG + 3] = cfg.P_bg
    stds[layout.BA:layout.BA + 3] = cfg.P_ba
    stds[layout.WBC:layout.WBC + 3] = cfg.P_Wbc
    stds[layout.TBC:layout.TBC + 3] = cfg.P_Tbc
    stds[layout.WSG:layout.WSG + 2] = cfg.P_Wsg
    # factor P = S S^T: the diagonal factor plus the slack workspace
    from .sqrt_form import slack_cols
    P = t(np.pad(np.diag(stds), ((0, 0), (0, slack_cols(d)))))

    _, intrin, _ = cam_mod.intrinsics_from_vio_cfg(cfg, dtype=dt, device=dev)

    NF, NG = d.nf_rows, d.ng_rows
    i64 = dict(dtype=torch.int64, device=dev)
    fd = dict(dtype=dt, device=dev)
    feats = FeatureTable(
        fid=torch.full((NF,), -1, **i64),
        status=torch.zeros((NF,), **i64),
        track=torch.zeros((NF,), **i64),
        ref=torch.full((NF,), -1, **i64),
        x=torch.zeros((NF, 3), **fd),
        Psub=torch.zeros((NF, 3, 3), **fd),
        sind=torch.full((NF,), -1, **i64),
        init_counter=torch.zeros((NF,), **i64),
        lifetime=torch.zeros((NF,), **i64),
        outlier_counter=torch.zeros((NF,), **fd),
        xp=torch.zeros((NF, 2), **fd),
        pred=torch.full((NF, 2), -1.0, **fd),
        tri_ok=torch.zeros((NF,), dtype=torch.bool, device=dev),
        adj=torch.zeros((NF, NG), dtype=torch.bool, device=dev),
        adj_xp=torch.zeros((NF, NG, 2), **fd),
        sim_depth=torch.full((NF,), -1.0, **fd),
        desc=torch.zeros((NF, 8), **i64),
        x_fej=torch.zeros((NF, 3), **fd),
    )
    eye = torch.eye(3, **fd)
    groups = GroupTable(
        gid=torch.full((NG,), -1, **i64),
        Rsb=eye.repeat(NG, 1, 1),
        Tsb=torch.zeros((NG, 3), **fd),
        lifetime=torch.zeros((NG,), **i64),
        sind=torch.full((NG,), -1, **i64),
        Rsb_fej=eye.repeat(NG, 1, 1),
        Tsb_fej=torch.zeros((NG, 3), **fd),
        is_clone=torch.zeros((NG,), dtype=torch.bool, device=dev),
    )
    return VIOState(
        X=X, cam=intrin, P=P, features=feats, groups=groups,
        g2row=torch.full((d.n_groups,), -1, **i64),
        f2row=torch.full((d.n_features,), -1, **i64),
        gauge_row=torch.tensor(-1, **i64),
        init_z=t(cfg.init_z),
        last_gyro=torch.zeros(3, **fd), last_accel=torch.zeros(3, **fd),
        slope_gyro=torch.zeros(3, **fd), slope_accel=torch.zeros(3, **fd),
        td_applied=t(cfg.X_td),
        vision_counter=torch.tensor(0, **i64),
        next_gid=torch.tensor(0, **i64),
        next_fid=torch.tensor(0, **i64),
        oc_R=X.Rsb.clone(), oc_V=X.Vsb.clone(), oc_T=X.Tsb.clone(),
        n_tracker_rejected=torch.tensor(0, **i64),
    )


def tree_map(fn, tree):
    """Apply fn to every tensor leaf of a (nested) NamedTuple."""
    if isinstance(tree, tuple):
        return _rebuild(tree, [tree_map(fn, x) for x in tree])
    return fn(tree)


def _rebuild(like, items):
    return type(like)(*items) if hasattr(like, "_fields") else tuple(items)


def where_state(mask, a, b):
    """Per-batch-item select between two states of the same structure:
    item i of the result is a's where mask[i], else b's. This is the
    port's form of ``lax.cond`` under ``vmap`` (both sides computed).
    Leaves the two sides share are passed through untouched."""
    if isinstance(a, tuple):
        return _rebuild(a, [where_state(mask, x, y) for x, y in zip(a, b)])
    if a is b:
        return a
    m = mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim()))
    return torch.where(m, a, b)
