"""Live 3D trajectory / frustum / landmark viewer (port of
``xivo_tpu/viz_live.py``).

Matplotlib-animation replacement for the reference's Pangolin viewer
(src/viewer.h:17-49, src/viewer.cpp): same update surface —
``Update_gsb`` / ``Update_gbc`` / ``Update_gsc`` accumulate the body
trace and current camera pose, ``Update(img)`` sets the camera image,
``Refresh()`` redraws. On a display it runs interactively (plt.ion);
headless it renders to the Agg canvas, so the drawing path is fully
exercisable in CI and frames can be saved with ``save_frame``.

Out of the perf path by design (SURVEY §2.5): everything here is
host-side numpy on already-materialized state.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np


class LiveViewer:
    """Incremental 3D view: body trajectory, camera frustum, landmarks.

    Parity: Viewer ctor config keys (src/viewer.cpp reads imh/imw, K,
    znear/zfar, bg color) map to the kwargs below; the trace_ member is
    ``self._trace``.
    """

    def __init__(self, name: str = "xivo_tpu_torch", imh: int = 480,
                 imw: int = 640, fx: float = 400.0, fy: float = 400.0,
                 cx: float = 320.0, cy: float = 240.0,
                 znear: float = 0.05, zfar: float = 10.0,
                 show_image: bool = True, interactive: Optional[bool]
                 = None):
        import matplotlib
        if interactive is None:
            interactive = bool(os.environ.get("DISPLAY"))
        if not interactive:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        self._plt = plt
        self._interactive = interactive
        self._name = name
        self._imh, self._imw = int(imh), int(imw)
        self._K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        self._znear, self._zfar = float(znear), float(zfar)

        self._fig = plt.figure(name, figsize=(10, 6))
        if show_image:
            self._ax3 = self._fig.add_subplot(1, 2, 1, projection="3d")
            self._axim = self._fig.add_subplot(1, 2, 2)
            self._axim.set_axis_off()
            self._im_artist = None
        else:
            self._ax3 = self._fig.add_subplot(1, 1, 1, projection="3d")
            self._axim = None
            self._im_artist = None
        self._ax3.set_xlabel("x [m]")
        self._ax3.set_ylabel("y [m]")
        self._ax3.set_zlabel("z [m]")

        self._trace = []            # body positions in spatial frame
        self._Rsb = np.eye(3)
        self._Tsb = np.zeros(3)
        self._Rbc = np.eye(3)
        self._Tbc = np.zeros(3)
        self._Rsc = None            # explicit override via Update_gsc
        self._Tsc = None
        self._img = None
        self._landmarks = np.zeros((0, 3))
        self.n_refreshed = 0

        self._traj_line, = self._ax3.plot([], [], [], "b-", lw=1,
                                          label="trajectory")
        self._lm_scatter = self._ax3.scatter([], [], [], s=4, c="g",
                                             label="landmarks")
        self._frustum_lines = [self._ax3.plot([], [], [], "r-", lw=1)[0]
                               for _ in range(8)]
        self._ax3.legend(loc="upper left", fontsize=7)
        if interactive:
            plt.ion()
            plt.show(block=False)

    # -- update surface (Viewer::Update_* parity) -----------------------

    def Update_gsb(self, Rsb, Tsb):
        self._Rsb = np.asarray(Rsb, float).reshape(3, 3)
        self._Tsb = np.asarray(Tsb, float).reshape(3)
        self._trace.append(self._Tsb.copy())

    def Update_gbc(self, Rbc, Tbc):
        self._Rbc = np.asarray(Rbc, float).reshape(3, 3)
        self._Tbc = np.asarray(Tbc, float).reshape(3)

    def Update_gsc(self, Rsc, Tsc):
        self._Rsc = np.asarray(Rsc, float).reshape(3, 3)
        self._Tsc = np.asarray(Tsc, float).reshape(3)

    def Update(self, img):
        self._img = np.asarray(img)

    def Update_landmarks(self, Xs):
        """Instate landmark positions (spatial frame), (N, 3)."""
        self._landmarks = np.asarray(Xs, float).reshape(-1, 3)

    # -- drawing ---------------------------------------------------------

    def _gsc(self):
        if self._Rsc is not None:
            return self._Rsc, self._Tsc
        return (self._Rsb @ self._Rbc,
                self._Rsb @ self._Tbc + self._Tsb)

    def _frustum_corners(self, depth):
        """Image corners back-projected to `depth`, camera frame."""
        Kinv = np.linalg.inv(self._K)
        px = np.array([[0, 0, 1], [self._imw, 0, 1],
                       [self._imw, self._imh, 1], [0, self._imh, 1]],
                      float).T
        return (Kinv @ px) * depth          # (3, 4)

    def Refresh(self):
        tr = np.asarray(self._trace) if self._trace else \
            np.zeros((0, 3))
        self._traj_line.set_data_3d(tr[:, 0], tr[:, 1], tr[:, 2])
        lm = self._landmarks
        self._lm_scatter._offsets3d = (lm[:, 0], lm[:, 1], lm[:, 2])

        # frustum: 4 rays apex->corner + 4 far-plane edges, world frame
        Rsc, Tsc = self._gsc()
        corners = Rsc @ self._frustum_corners(
            min(0.5, self._zfar)) + Tsc[:, None]
        for i in range(4):
            a, b = Tsc, corners[:, i]
            self._frustum_lines[i].set_data_3d(
                [a[0], b[0]], [a[1], b[1]], [a[2], b[2]])
            c, d = corners[:, i], corners[:, (i + 1) % 4]
            self._frustum_lines[4 + i].set_data_3d(
                [c[0], d[0]], [c[1], d[1]], [c[2], d[2]])

        pts = [tr, lm, Tsc[None]] if len(tr) else [lm, Tsc[None]]
        allp = np.concatenate([p for p in pts if len(p)], axis=0)
        if len(allp):
            lo, hi = allp.min(0) - 0.5, allp.max(0) + 0.5
            self._ax3.set_xlim(lo[0], hi[0])
            self._ax3.set_ylim(lo[1], hi[1])
            self._ax3.set_zlim(lo[2], hi[2])

        if self._axim is not None and self._img is not None:
            if self._im_artist is None:
                self._im_artist = self._axim.imshow(self._img,
                                                    cmap="gray")
            else:
                self._im_artist.set_data(self._img)
                self._im_artist.set_clim(self._img.min(),
                                         max(1, self._img.max()))

        if self._interactive:
            self._fig.canvas.draw_idle()
            self._fig.canvas.flush_events()
            self._plt.pause(0.001)
        else:
            self._fig.canvas.draw()
        self.n_refreshed += 1

    def save_frame(self, path: str):
        self._fig.savefig(path, dpi=80)
        return path

    def close(self):
        self._plt.close(self._fig)

    # -- estimator glue --------------------------------------------------

    def update_from_estimator(self, est, img=None):
        """One-call refresh from the port's api.Estimator: pose, calib,
        instate landmarks, optional camera image."""
        Rsb, Tsb = est.gsb()
        self.Update_gsb(Rsb, Tsb)
        Rbc, Tbc = est.gbc()
        self.Update_gbc(Rbc, Tbc)
        Xs, _ids = est.InstateFeaturePositions()
        if len(Xs):
            self.Update_landmarks(np.asarray(Xs))
        if img is not None:
            self.Update(img)
        self.Refresh()
