"""Asynchronous estimator process: worker thread + message queue (port
of ``xivo_tpu/api/process.py``).

Port of the reference's EstimatorProcess (src/estimator_process.{h,cpp},
common/process.h): measurements enqueue without blocking the producer; a
worker thread drains them into the Estimator and invokes publisher
callbacks after each visual update; each visual message is one frame
step of the port's ``Estimator``, on the device the estimator was built
for.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, List, Optional

import numpy as np

from .estimator import Estimator


class EstimatorProcess:
    """Threaded wrapper with publisher callbacks (Publisher parity,
    src/publisher.{h,cpp}): pose_cb(ts, Rsb, Tsb, Pstate),
    map_cb(positions, ids), state_cb(estimator)."""

    def __init__(self, est: Estimator, maxsize: int = 1000):
        self.est = est
        self.q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self.pose_callbacks: List[Callable] = []
        self.map_callbacks: List[Callable] = []
        self.state_callbacks: List[Callable] = []
        # display-image callback: cb(ts, image, tracked_pixels) — the
        # Publish(cv::Mat) seam (src/estimator_process.cpp:32-45)
        self.image_callbacks: List[Callable] = []
        # 2D nav-state callback: cb(ts, x, y, yaw) — Publish2dNavState
        # parity (src/estimator_process.cpp:79-96)
        self.nav2d_callbacks: List[Callable] = []
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def Start(self):
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def Wait(self):
        """Block until the queue drains (ScopedWait parity)."""
        self.q.join()

    def Stop(self):
        self._stop.set()
        self.q.put(None)
        if self._worker is not None:
            self._worker.join()

    # producer side -----------------------------------------------------
    def InertialMeas(self, ts, gyro, accel):
        self.q.put(("imu", ts, np.asarray(gyro), np.asarray(accel)))

    def VisualMeas(self, ts, image):
        self.q.put(("img", ts, image))

    def VisualMeasPointCloud(self, ts, ids, xpd):
        self.q.put(("pc", ts, np.asarray(ids), np.asarray(xpd)))

    # worker side -------------------------------------------------------
    def _run(self):
        while not self._stop.is_set():
            msg = self.q.get()
            if msg is None:
                self.q.task_done()
                break
            try:
                kind = msg[0]
                if kind == "imu":
                    self.est.InertialMeas(msg[1], msg[2], msg[3])
                elif kind == "img":
                    self.est.VisualMeas(msg[1], msg[2])
                    self._publish(msg[1], image=msg[2])
                elif kind == "pc":
                    self.est.VisualMeasPointCloud(msg[1], msg[2], msg[3])
                    self._publish(msg[1])
            finally:
                self.q.task_done()

    def _publish(self, ts, image=None):
        for cb in self.pose_callbacks:
            Rsb, Tsb = self.est.gsb()
            cb(ts, Rsb, Tsb, self.est.Pstate())
        for cb in self.map_callbacks:
            pos, ids = self.est.InstateFeaturePositions()
            cb(pos, ids)
        for cb in self.state_callbacks:
            cb(self.est)
        if image is not None:
            for cb in self.image_callbacks:
                cb(ts, image, self.est.tracked_features())
        for cb in self.nav2d_callbacks:
            Rsb, Tsb = self.est.gsb()
            yaw = float(np.arctan2(Rsb[1, 0], Rsb[0, 0]))
            cb(ts, float(Tsb[0]), float(Tsb[1]), yaw)
