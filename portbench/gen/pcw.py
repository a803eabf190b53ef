"""Point-cloud-world vision simulation (a frozen copy of the program's
``sim/pcw.py``: ``PointCloudWorld`` and ``RandomPCW``).

After scripts/point_cloud_world.py: a set of 3D landmarks projected
through a pinhole camera with id-on-first-visibility association and
pixel noise — the deterministic "fake backend" that exercises the full
filter with exact ground truth (SURVEY.md §4 tier 3).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
from numpy.random import default_rng

ID0 = 10000  # matches Feature::counter0 (src/feature.h:227)


class PointCloudWorld:
    def __init__(self, seed=None):
        self.Xs = np.zeros((0, 3))
        self.ids = np.zeros((0,), np.int64)
        self.next_id = ID0
        self.rng = default_rng(seed)

    def add_points(self, Xs: np.ndarray):
        Xs = np.atleast_2d(np.asarray(Xs, float))
        self.Xs = np.vstack([self.Xs, Xs])
        self.ids = np.concatenate(
            [self.ids, -np.ones(len(Xs), np.int64)])

    def generate_measurements(self, Rsc, Tsc, K, imw, imh,
                              noise_px_std=0.0
                              ) -> Tuple[np.ndarray, np.ndarray]:
        """Project all points into the camera at (Rsc, Tsc).

        Returns (ids (M,), xp_and_depth (M, 3)) for visible points; ids
        persist while visible and reset when the point leaves the view
        (scripts/point_cloud_world.py:58-95).
        """
        Xc = (self.Xs - Tsc[None, :]) @ Rsc  # = Rsc^T (Xs - Tsc)
        z = Xc[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            xn = Xc[:, :2] / z[:, None]
        xp = xn * np.array([K[0, 0], K[1, 1]]) + np.array([K[0, 2], K[1, 2]])
        vis = (z > 0) & (xp[:, 0] >= 0) & (xp[:, 1] >= 0) \
            & (xp[:, 0] <= imw) & (xp[:, 1] <= imh)
        if noise_px_std > 0:
            xp = xp + noise_px_std * self.rng.standard_normal(xp.shape)

        # id management
        newly = vis & (self.ids < 0)
        n_new = int(newly.sum())
        self.ids[newly] = np.arange(self.next_id, self.next_id + n_new)
        self.next_id += n_new
        self.ids[~vis] = -1

        return self.ids[vis].copy(), np.concatenate(
            [xp[vis], z[vis, None]], axis=1)


class RandomPCW(PointCloudWorld):
    def __init__(self, xlim, ylim, zlim, n_points=1000, seed=None):
        super().__init__(seed)
        pts = np.stack([
            self.rng.uniform(xlim[0], xlim[1], n_points),
            self.rng.uniform(ylim[0], ylim[1], n_points),
            self.rng.uniform(zlim[0], zlim[1], n_points)], axis=1)
        self.add_points(pts)
