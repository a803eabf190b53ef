"""Reload-and-analyze lattice for estimator dumps (port of
``xivo_tpu/eval/estimator_data.py``, a numpy copy).

Port of the reference's ``scripts/estimator_data.py`` (the analysis-side
companion of the saver lattice): re-loads a StateDumpWriter JSON dump
into time-indexed arrays with per-block views of the state and its
covariance, the substrate for sigma-bound / calibration-convergence
studies (scripts/accuracy_plots.py, calibration_plots.py in the
reference; scripts/calibration_plots.py here).
"""
from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np

from ..filter import layout as L

# motion-block slices by name (error-state layout, filter/layout.py)
BLOCKS = {
    "Wsb": (L.WSB, 3), "Tsb": (L.TSB, 3), "Vsb": (L.VSB, 3),
    "bg": (L.BG, 3), "ba": (L.BA, 3), "Wbc": (L.WBC, 3),
    "Tbc": (L.TBC, 3), "Wsg": (L.WSG, 2), "td": (L.TD, 1),
    "Cg": (L.CG, 9), "Ca": (L.CA, 6),
}


class EstimatorData:
    """Time-indexed view of a state dump (EstimatorData parity).

    Attributes: ts (T,), and per-state arrays Tsb/Wsb/Vsb/bg/ba/Tbc/
    Wbc (T,3), td (T,), counts, and Pstate (T, MOTION, MOTION) when the
    dump carried covariance.
    """

    def __init__(self, path: str):
        with open(path) as f:
            frames = json.load(f)
        if isinstance(frames, dict) and "data" in frames:
            # CovDumpWriter format ({"data": [...]}, io/savers.py —
            # reference scripts/savers.py:157-281): normalize entries
            # to the StateDumpWriter field names
            frames = [self._from_covdump(e) for e in frames["data"]]
        if not frames:
            raise ValueError(f"empty dump: {path}")
        self.ts = np.asarray([fr["ts"] for fr in frames])
        for k in ("Tsb", "Wsb", "Vsb", "bg", "ba", "Tbc", "Wbc"):
            setattr(self, k, np.asarray([fr[k] for fr in frames]))
        self.td = np.asarray([fr["td"] for fr in frames])
        self.num_instate_features = np.asarray(
            [fr["num_instate_features"] for fr in frames])
        self.num_instate_groups = np.asarray(
            [fr["num_instate_groups"] for fr in frames])
        self.Pstate: Optional[np.ndarray] = None
        if "Pstate" in frames[0]:
            self.Pstate = np.asarray([fr["Pstate"] for fr in frames])

    @staticmethod
    def _from_covdump(e: dict) -> dict:
        def w_of(q_wxyz):
            from scipy.spatial.transform import Rotation
            w, x, y, z = q_wxyz
            return Rotation.from_quat([x, y, z, w]).as_rotvec().tolist()

        out = dict(
            ts=e["Timestamp"], Tsb=e["Tsb_XYZ"], Wsb=w_of(e["qsb_WXYZ"]),
            Vsb=e["Vsb_XYZ"], bg=e["bg"], ba=e["ba"],
            Tbc=e["Tbc_XYZ"], Wbc=w_of(e["qbc_WXYZ"]), td=e["td"],
            num_instate_features=e["num_instate_features"],
            num_instate_groups=e["num_instate_groups"])
        if "Pstate" in e:
            out["Pstate"] = e["Pstate"]
        return out

    def __len__(self):
        return len(self.ts)

    def sigma(self, block: str) -> np.ndarray:
        """(T, k) per-entry standard deviations of a motion block."""
        if self.Pstate is None:
            raise ValueError("dump was written without save_cov=True")
        off, k = BLOCKS[block]
        d = np.diagonal(self.Pstate, axis1=1, axis2=2)[:, off:off + k]
        return np.sqrt(np.maximum(d, 0.0))

    def state(self, block: str) -> np.ndarray:
        """(T, k) nominal values of a motion block (where dumped)."""
        if block == "td":
            return self.td[:, None]
        return getattr(self, block)

    def error_vs(self, block: str, truth) -> np.ndarray:
        """(T, k) estimation error against a constant or (T, k) truth."""
        x = self.state(block)
        return x - np.broadcast_to(np.asarray(truth, x.dtype), x.shape)

    def within_sigma_fraction(self, block: str, truth,
                              n_sigma: float = 3.0) -> float:
        """Fraction of (frame, axis) samples whose error lies inside
        +-n_sigma — the calibration-consistency scalar the sigma-bound
        plots visualize."""
        err = self.error_vs(block, truth)
        sig = self.sigma(block)
        ok = np.abs(err) <= n_sigma * np.maximum(sig, 1e-12)
        return float(ok.mean())


def load_trajectory(path: str) -> Dict[str, np.ndarray]:
    """Read a TrajectoryWriter TUM file -> dict(ts, T (N,3), q (N,4))."""
    rows = np.loadtxt(path)
    return dict(ts=rows[:, 0], T=rows[:, 1:4], q=rows[:, 4:8])
