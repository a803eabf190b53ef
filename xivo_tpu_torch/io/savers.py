"""Output serialization (port of ``xivo_tpu/io/savers.py``).

Port of the reference saver lattice (scripts/savers.py: Eval/Dump/
CovDump modes) and the `vio` app's "ts Tsb Wsb" trajectory lines
(src/app/vio.cpp:101-106). The files are the JAX package's, byte for
byte where the values agree. The writers read the estimator through its
pyxivo accessors (numpy), so they serve the port's ``Estimator``, whose
state carries a batch axis of 1; rotation logs use the port's
``geom/so3``.
"""
from __future__ import annotations

import json
import os
from typing import List

import numpy as np
import torch

from ..geom import so3


def _log(R) -> list:
    """Rotation vector of a (3, 3) numpy rotation, in its dtype."""
    return so3.log(torch.from_numpy(np.array(R))).numpy().tolist()


class TrajectoryWriter:
    """TUM-format trajectory: 'ts tx ty tz qx qy qz qw' per line
    (what run_and_eval consumes)."""

    def __init__(self, path: str):
        self.path = path
        self.rows: List[str] = []

    def add(self, ts: float, Rsb: np.ndarray, Tsb: np.ndarray):
        from scipy.spatial.transform import Rotation
        q = Rotation.from_matrix(np.asarray(Rsb)).as_quat()  # x y z w
        self.rows.append(
            f"{ts:.9f} {Tsb[0]:.9f} {Tsb[1]:.9f} {Tsb[2]:.9f} "
            f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}")

    def write(self):
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        with open(self.path, "w") as f:
            f.write("\n".join(self.rows) + "\n")


class StateDumpWriter:
    """Full-state JSON dump per frame (scripts/savers.py DumpModeSaver):
    pose, velocity, biases, calib states, optional covariance."""

    def __init__(self, path: str, save_cov: bool = False):
        self.path = path
        self.save_cov = save_cov
        self.frames = []

    def add(self, ts: float, est):
        Rsb, Tsb = est.gsb()
        Rbc, Tbc = est.gbc()
        rec = dict(
            ts=ts,
            Tsb=np.asarray(Tsb).tolist(),
            Wsb=_log(Rsb),
            Vsb=np.asarray(est.Vsb()).tolist(),
            bg=np.asarray(est.bg()).tolist(),
            ba=np.asarray(est.ba()).tolist(),
            Tbc=np.asarray(Tbc).tolist(),
            Wbc=_log(Rbc),
            td=float(est.td()),
            num_instate_features=est.num_instate_features(),
            num_instate_groups=est.num_instate_groups(),
        )
        if self.save_cov:
            rec["Pstate"] = est.Pstate().tolist()
        self.frames.append(rec)

    def write(self):
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        with open(self.path, "w") as f:
            json.dump(self.frames, f)


class CovDumpWriter:
    """Per-frame FULL diagnostic dump — the CovDumpModeSaver of the
    reference saver lattice (scripts/savers.py:157-281): camera/body
    poses as quaternions, velocity, biases, gravity rotation, td/Ca/Cg,
    camera intrinsics, the motion-block covariance, instate feature and
    group tensors (positions, covariances, ids, sinds), and the
    rejection counters. Output format: {"data": [entry, ...]} like the
    reference's onResultsReady.
    """

    def __init__(self, path: str, save_full_cov: bool = False):
        self.path = path
        self.save_full_cov = save_full_cov
        self.entries = []

    def add(self, ts: float, est):
        from scipy.spatial.transform import Rotation

        def q_wxyz(R):
            x, y, z, w = Rotation.from_matrix(np.asarray(R)).as_quat()
            return [float(w), float(x), float(y), float(z)]

        Rsb, Tsb = est.gsb()
        Rbc, Tbc = est.gbc()
        Rsc, Tsc = est.gsc()
        feat_pos, feat_ids = est.InstateFeaturePositions()
        entry = dict(
            Timestamp=float(ts),
            Tsb_XYZ=np.asarray(Tsb).tolist(), qsb_WXYZ=q_wxyz(Rsb),
            Tbc_XYZ=np.asarray(Tbc).tolist(), qbc_WXYZ=q_wxyz(Rbc),
            Tsc_XYZ=np.asarray(Tsc).tolist(), qsc_WXYZ=q_wxyz(Rsc),
            Vsb_XYZ=np.asarray(est.Vsb()).tolist(),
            bg=np.asarray(est.bg()).tolist(),
            ba=np.asarray(est.ba()).tolist(),
            qg_WXYZ=q_wxyz(est.Rg()),
            td=float(est.td()),
            Ca=np.asarray(est.Ca()).tolist(),
            Cg=np.asarray(est.Cg()).tolist(),
            camera_intrinsics=np.asarray(
                est.camera_intrinsics()).tolist(),
            camera_type=est.CameraDistortionType(),
            Pstate=np.asarray(est.Pstate()).tolist(),
            num_instate_features=est.num_instate_features(),
            feature_positions=np.asarray(feat_pos).tolist(),
            feature_covs=np.asarray(est.InstateFeatureCovs()).tolist(),
            feature_ids=np.asarray(feat_ids).tolist(),
            feature_sinds=np.asarray(est.InstateFeatureSinds()).tolist(),
            num_instate_groups=est.num_instate_groups(),
            group_poses=[
                dict(q_WXYZ=q_wxyz(R), T_XYZ=np.asarray(T).tolist(),
                     gid=int(g))
                for R, T, g in zip(*est.InstateGroupPoses())],
            group_covs=np.asarray(est.InstateGroupCovs()).tolist(),
            group_ids=np.asarray(est.InstateGroupIDs()).tolist(),
            group_sinds=np.asarray(est.InstateGroupSinds()).tolist(),
            num_mh_rejected=est.num_mh_rejected(),
            num_oneptransac_rejected=est.num_oneptransac_rejected(),
            num_tracker_outlier_rejected=(
                est.num_tracker_outlier_rejected()),
        )
        if self.save_full_cov:
            entry["P"] = est.P().tolist()
        self.entries.append(entry)

    def write(self):
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        with open(self.path, "w") as f:
            json.dump({"data": self.entries}, f)


class TrackerDumpWriter:
    """Per-track CSV lines 'ts,id,x,y,d0..d7' — the TrackerDumpModeSaver
    (scripts/savers.py:282-313) with the packed uint32x8 descriptor
    format of frontend/brief.py."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        open(self.path, "w").close()

    def add(self, ts: float, est):
        fid, xp, desc = est.tracked_features()
        if len(fid) == 0:
            return
        with open(self.path, "a") as f:
            for i in range(len(fid)):
                d = ",".join(str(int(v)) for v in np.asarray(desc[i]))
                f.write(f"{ts:.9f},{int(fid[i])},{xp[i][0]:.4f},"
                        f"{xp[i][1]:.4f},{d}\n")


def load_tracker_dump(path: str):
    """Reload a TrackerDumpWriter file -> dict(ts, fid, xp, desc)."""
    rows = np.loadtxt(path, delimiter=",", ndmin=2)
    return dict(ts=rows[:, 0], fid=rows[:, 1].astype(np.int64),
                xp=rows[:, 2:4],
                desc=rows[:, 4:].astype(np.uint32))
