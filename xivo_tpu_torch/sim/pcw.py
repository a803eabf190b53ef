"""Point-cloud-world vision simulation.

Port of scripts/point_cloud_world.py: a set of 3D landmarks projected
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


class ShellPCW(PointCloudWorld):
    """Points on a spherical shell enclosing the trajectory volume.

    Fixes the long-horizon starvation of box-uniform worlds (measured:
    RandomPCW visibility collapses to zero on 20 s+ calib_rich/gentle
    runs as the camera sweeps feature-free directions) — a shell keeps
    every viewing direction populated, which is what long-horizon
    stability and consistency (NEES) studies need.
    """

    def __init__(self, r_min=6.0, r_max=10.0, n_points=1500, seed=None):
        super().__init__(seed)
        u = self.rng.standard_normal((n_points, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        r = self.rng.uniform(r_min, r_max, n_points)[:, None]
        self.add_points(u * r)


class TubePCW(PointCloudWorld):
    """Points in a tube around a given trajectory.

    The generic fix for long-horizon starvation on TRAVERSING
    trajectories (calib_rich/gentle cover tens of meters — no fixed
    shell can enclose them at useful parallax): sample landmarks within
    a [r_min, r_max] distance band of the path so every pose has nearby
    structure in most viewing directions.
    """

    def __init__(self, path_xyz: np.ndarray, r_min=1.0, r_max=6.0,
                 n_points=2000, seed=None):
        super().__init__(seed)
        path = np.atleast_2d(np.asarray(path_xyz, float))
        anchors = path[self.rng.integers(0, len(path), n_points)]
        u = self.rng.standard_normal((n_points, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        r = self.rng.uniform(r_min, r_max, n_points)[:, None]
        self.add_points(anchors + u * r)


class Checkerboard(PointCloudWorld):
    """Grid of corner landmarks on a plane (point_cloud_world.py:150-216)."""

    def __init__(self, square_width=0.05, dim_squares=(7, 6),
                 bot_right_coord=(0.0, 0.25, 0.0), plane="xz", seed=None):
        super().__init__(seed)
        nw, nh = dim_squares
        xs, ys, zs = bot_right_coord
        pts = []
        for i in range(nw + 1):
            for j in range(nh + 1):
                if plane == "xz":
                    pts.append([xs + i * square_width, ys,
                                zs + j * square_width])
                else:
                    pts.append([xs + i * square_width,
                                ys + j * square_width, zs])
        self.add_points(np.asarray(pts))
