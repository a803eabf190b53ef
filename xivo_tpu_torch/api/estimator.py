"""Streaming estimator API mirroring the pyxivo surface (port of
``xivo_tpu/api/estimator.py``).

The host-side driver around the port's frame steps: message reordering,
gravity initialization, IMU batching per visual frame, and the accessors
of the reference Python binding (pybind11/pyxivo.cpp:332-398). The
estimator runs one sequence: its state carries a batch axis of 1, and
each visual frame is one eager call of the batched step (``vio_frame``,
``vio_frame_image``, or with ``use_mapper`` the mapped steps).

Differences from the JAX package's estimator, none of which changes a
result:

* Each frame's inputs are packed on the host and uploaded from pinned
  memory, floats in one copy and integers in another
  (``non_blocking``), so that no frame entry point waits for the device.
  The IMU axis is trimmed to the frame's samples (at most ``IMU_CAP``);
  its padding rows were no-ops.
* The random draws of the homography RANSAC and of loop closure's P3P
  RANSAC come from one ``torch.Generator`` on the estimator's device,
  seeded as the runners' (``seed=0``) and drawn in the order of
  ``runner.run_batch_mapped`` and ``runner.run_batch_image``; the
  reference draws them from its state's key. So the estimator reproduces
  the runners at B = 1, bit for bit.
* The capped substep loops (``filter/propagate.py``) get a cap sized to
  each frame's intervals (``runner.fit_substeps``). Adaptive steps keep
  ``cfg.max_substeps``; ``flush`` reads the device's substep counters once
  and raises if the cap left an interval unfinished.
* The closure rows of the last mapped frame stay on the device until
  ``num_loop_closure_rows`` reads them, and the current td is read for
  the ordering key of a visual message only when the reorder buffer is
  on (``message_buffer_size > 0``), the only case that uses it.
* Checkpoints are the port's own format (``save_checkpoint``).

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from .. import interop, resolve_device
from .. import runner as R
from ..filter import propagate
from ..filter import layout as L
from ..filter.config import (VIOConfig, config_from_json,
                             load_json_with_comments)
from ..filter.pipeline import tracker_pointcloud, vio_frame
from ..filter.state import (TS_CREATED, TS_DROPPED, TS_TRACKED,
                            check_supported, torch_dtype)
from ..frontend.tracker import tracker_only_frame, vio_frame_image
from ..geom import so3
from ..map.integration import vio_frame_image_mapped, vio_frame_mapped

IMU_CAP = 32      # max IMU samples buffered per visual frame
MEAS_CAP = 256    # max point measurements per visual frame


def _np(t: torch.Tensor) -> np.ndarray:
    """The one sequence's entry of a batched tensor, as numpy with the
    reference's integer dtype."""
    a = t[0].detach().cpu().numpy()
    return a.astype(np.int32) if a.dtype == np.int64 else a


class Estimator:
    """Drop-in analogue of pyxivo.Estimator (point-cloud and image paths)."""

    def __init__(self, cfg, viewer_cfg=None, name: str = "",
                 tracker_only: bool = False, dims=None,
                 dtype: Optional[str] = None, device="cuda", **overrides):
        # positional signature mirrors pyxivo.Estimator(cfg, viewer_cfg,
        # name, tracker_only) (pybind11/pyxivo.cpp:19-40); viewer_cfg is
        # accepted for compatibility (viz.py replaces the Pangolin viewer)
        if isinstance(cfg, str):
            cfg = load_json_with_comments(cfg)
        if isinstance(cfg, dict):
            cfg = config_from_json(cfg, dims=dims, **overrides)
        if dtype is not None:
            cfg = dataclasses.replace(cfg, dtype=dtype)
        check_supported(cfg)
        self.cfg: VIOConfig = cfg
        self.name = name
        self.tracker_only = tracker_only
        self.device = resolve_device(device)
        self.state = R.batch_states(cfg, 1, self.device)
        self._gen = R.draw_generator(self.state)
        self._map = (R.batch_maps(cfg.map_capacity, 1, self.device,
                                  torch_dtype(cfg))
                     if cfg.use_mapper else None)

        self.gravity_initialized = cfg.simulation  # sims skip gravity init
        self.vision_initialized = False
        self._grav_buf = []
        self._pending_imu = []     # [(ts, gyro, accel)]
        self._last_prop_time = None
        self._last_out = None
        self._last_n_lc = None
        self._counting = False     # substep counters zeroed by this one
        self._seq = itertools.count()
        # out-of-order message reordering (src/estimator.cpp:923-941):
        # a min-heap of (ts, seq, kind, payload) drained once its depth
        # exceeds cfg.message_buffer_size; stragglers older than the
        # system clock are dropped (src/estimator.cpp:1108-1110,
        # GoodTimestamp at millisecond granularity). Size 0 = immediate
        # dispatch (the replay drivers feed pre-sorted streams).
        self._buf = []             # reorder heap [(ts, seq, kind, payload)]
        self._clock = -float("inf")
        self._n_misordered_dropped = 0
        self._fes = None           # frontend (image-path) state
        self._live_viewer = None

    # ------------------------------------------------------------------
    # measurement entry points (pyxivo parity)
    # ------------------------------------------------------------------
    #
    # Every entry point routes through the reorder buffer: messages are
    # pushed onto a timestamp min-heap and executed oldest-first only
    # once the heap is deeper than cfg.message_buffer_size — the drain
    # semantics of Estimator::MaintainBuffer (src/estimator.cpp:923-941).
    # With message_buffer_size=0 (default) dispatch is immediate and
    # behavior is identical to in-order delivery. The online-td
    # timestamp shift happens at PUSH time for visual messages
    # (src/estimator.cpp:943-951), so reordering sees shifted stamps.

    def _push(self, ts: float, kind: str, payload, order_ts=None):
        """order_ts: heap/clock ordering key when it differs from the
        execution timestamp — visual messages order by their td-shifted
        stamp (src/estimator.cpp:943-951) while propagation intervals
        stay in the raw clock domain (the frame step's dt_eff correction in
        propagate_frame owns the td physics; shifting here too would
        double-apply the drift)."""
        key = ts if order_ts is None else order_ts
        if self.cfg.message_buffer_size <= 0:
            self._execute(ts, kind, payload)
            return
        heapq.heappush(self._buf, (key, next(self._seq), kind, ts, payload))
        while len(self._buf) > self.cfg.message_buffer_size:
            self._pop_execute()

    def _pop_execute(self):
        key, _, kind, ts, payload = heapq.heappop(self._buf)
        # GoodTimestamp (src/estimator.cpp:706-717): stragglers older
        # than the executed clock — at millisecond granularity, like the
        # reference's ms-truncated compare — are dropped, not rewound.
        if np.isfinite(self._clock) and int(np.floor(key * 1e3)) \
                < int(np.floor(self._clock * 1e3)):
            self._n_misordered_dropped += 1
            return
        self._clock = max(self._clock, key)
        self._execute(ts, kind, payload)

    def _execute(self, ts: float, kind: str, payload):
        if kind == "imu":
            self._inertial_meas_internal(ts, *payload)
        elif kind == "image":
            self._visual_meas_internal(ts, payload)
        elif kind == "pc":
            self._visual_meas_pc_internal(ts, *payload)
        elif kind == "image_tracker":
            self._visual_tracker_only_internal(ts, payload)
        elif kind == "pc_tracker":
            self._visual_pc_tracker_only_internal(ts, *payload)

    def flush(self):
        """Drain the reorder buffer (execute everything still queued).

        The reference never drains its tail — up to MESSAGE_BUFFER_SIZE
        messages are simply lost at shutdown. Finite-stream drivers here
        call flush() to process them. Where the config propagates through
        the capped substep loops, flush() then reads the device's substep
        counters (one host sync) and raises if an interval was left
        unfinished since this estimator's first frame.
        """
        while self._buf:
            self._pop_execute()
        if self._counting:
            propagate.check_substeps(self.device)

    def num_misordered_dropped(self):
        """Messages dropped for arriving with timestamps older than the
        executed clock (the reference logs and drops these,
        src/estimator.cpp:1108-1110)."""
        return self._n_misordered_dropped

    def _order_ts(self, ts: float):
        """A visual message's ordering key: shifted by the current td
        estimate with online temporal calibration. Only the reorder
        buffer reads it, so the device is not read without one."""
        if self.cfg.online_temporal_calib \
                and self.cfg.message_buffer_size > 0:
            return ts + float(self.state.X.td[0])
        return None

    def InertialMeas(self, ts: float, gyro, accel):
        self._push(ts, "imu", (np.asarray(gyro, float),
                               np.asarray(accel, float)))

    def _inertial_meas_internal(self, ts: float, gyro, accel):
        if not self.gravity_initialized:
            self._grav_buf.append(accel)
            if len(self._grav_buf) >= max(self.cfg.gravity_init_counter, 1):
                self._init_gravity(ts, gyro, accel)
            return
        if not self.vision_initialized:
            # the reference discards inertial input until vision starts,
            # but keeps the latest sample as the propagation seed
            self._seed_imu(ts, gyro, accel)
            return
        self._pending_imu.append((ts, gyro, accel))

    def VisualMeas(self, ts: float, image):
        """Image-measurement frame (the LK/FAST path).

        `image` is an (H, W) array or a path loadable by io.load_image —
        mirroring pyxivo's dual path/array binding
        (pybind11/pyxivo.cpp:46-78). With online temporal calibration,
        the CURRENT td estimate shifts the message's ordering stamp at
        push time (src/estimator.cpp:943-951); the propagation interval
        itself is corrected in the frame step (propagate_frame's dt_eff),
        so the shift is not applied twice.
        """
        if isinstance(image, str):
            from ..io import load_image
            image = load_image(image)
        image = np.asarray(image, np.float32)
        if self.tracker_only:
            self._push(ts, "image_tracker", image)
            return
        self._push(ts, "image", image, order_ts=self._order_ts(ts))

    def _visual_meas_internal(self, ts: float, image):
        if not self.gravity_initialized:
            return
        if self._fes is None:
            self._fes = R.batch_frontend_states(self.cfg, 1, self.device)
        if not self.vision_initialized:
            self.vision_initialized = True
            self._last_prop_time = ts
            self._run_image_frame(ts, [], image)
            return
        self._run_image_frame(ts, self._pending_imu, image)
        self._pending_imu = []

    def VisualMeasPointCloud(self, ts: float, ids, xp_and_depths):
        """Synthetic-measurement frame (VisualMeasPointCloudInternal)."""
        ids = np.asarray(ids)
        xpd = np.asarray(xp_and_depths, float).reshape(-1, 3)
        if self.tracker_only:
            self._push(ts, "pc_tracker", (ids, xpd))
            return
        self._push(ts, "pc", (ids, xpd), order_ts=self._order_ts(ts))

    def _visual_meas_pc_internal(self, ts: float, ids, xpd):
        if not self.gravity_initialized:
            return
        if not self.vision_initialized:
            self.vision_initialized = True
            self._last_prop_time = ts
            self._run_frame(ts, [], ids, xpd)
            return
        self._run_frame(ts, self._pending_imu, ids, xpd)
        self._pending_imu = []

    def VisualMeasTrackerOnly(self, ts: float, image):
        """Front-end only: track + detect, no filter (the
        feature_tracker_only app / CreateSystemTrackerOnly path)."""
        if isinstance(image, str):
            from ..io import load_image
            image = load_image(image)
        self._push(ts, "image_tracker", np.asarray(image, np.float32))

    def _visual_tracker_only_internal(self, ts: float, image):
        if self._fes is None:
            self._fes = R.batch_frontend_states(self.cfg, 1, self.device)
        hom, _ = self._draws()
        self.state, self._fes = tracker_only_frame(
            self.cfg, self.state, self._fes, self._upload(image)[None], hom)
        self._last_prop_time = ts

    def VisualMeasPointCloudTrackerOnly(self, ts: float, ids,
                                        xp_and_depths):
        """Point-cloud tracker association only, no filter."""
        self._push(ts, "pc_tracker",
                   (np.asarray(ids),
                    np.asarray(xp_and_depths, float).reshape(-1, 3)))

    def _visual_pc_tracker_only_internal(self, ts: float, ids, xpd):
        hom, _ = self._draws()
        (xp, depth), (mid, valid) = self._upload_frame(
            (), self._pack_meas(ids, xpd))
        self.state = tracker_pointcloud(self.cfg, self.state, mid, xp, depth,
                                        valid, hom)
        self._last_prop_time = ts

    def InitWithSimDepths(self):
        self.cfg = dataclasses.replace(self.cfg, sim_initialize_depths=True)

    def ScaleInitVelocity(self, scale: float):
        X = self.state.X
        self.state = self.state._replace(X=X._replace(Vsb=X.Vsb * scale))

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------

    def _init_gravity(self, ts, gyro, accel):
        """InitializeGravity parity (src/estimator.cpp:439-473)."""
        X = self.state.X
        mean_accel = np.mean(self._grav_buf, axis=0)
        Ca = _np(X.Ca)
        accel_calib = Ca @ mean_accel - _np(X.ba)
        g = -np.asarray(self.cfg.gravity)
        # rotation taking -g to accel_calib
        a = g / np.linalg.norm(g)
        b = accel_calib / max(np.linalg.norm(accel_calib), 1e-12)
        v = np.cross(a, b)
        s = np.linalg.norm(v)
        c = np.dot(a, b)
        w = v / s * np.arctan2(s, c) if s > 1e-12 else np.zeros(3)
        w[2] = 0.0
        Rsg = so3.exp(torch.from_numpy(np.asarray(w, np.float64))).numpy()
        self.state = self.state._replace(X=X._replace(
            Rsg=self._upload(self._host(Rsg))[None]))
        self._seed_imu(ts, gyro, accel)
        self.gravity_initialized = True
        self._grav_buf = []

    def _seed_imu(self, ts, gyro, accel):
        ga = self._upload(self._host(np.stack([gyro, accel])))
        z = torch.zeros_like(ga[0])[None]
        self.state = self.state._replace(
            last_gyro=ga[0][None], last_accel=ga[1][None],
            slope_gyro=z, slope_accel=z.clone())
        self._last_prop_time = ts

    def _host(self, a) -> np.ndarray:
        return np.asarray(a, np.dtype(self.cfg.dtype))

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the estimator's device: on CUDA through a
        pinned staging buffer, so the copy does not wait for the device."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t
        staged = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        staged.copy_(t)
        return staged.to(self.device, non_blocking=True)

    def _pack_imu(self, ts, imu):
        """The frame's IMU samples (at most IMU_CAP, at least one row of
        zeros) as gyro (K, 3), accel (K, 3), dts (K,), and the interval
        from the last sample to the frame."""
        imu = imu[:IMU_CAP]
        k = max(len(imu), 1)
        gyro = np.zeros((k, 3))
        accel = np.zeros((k, 3))
        dts = np.zeros((k,))
        t_prev = self._last_prop_time
        for i, (t, gy, ac) in enumerate(imu):
            gyro[i] = gy
            accel[i] = ac
            dts[i] = max(t - t_prev, 0.0)
            t_prev = t
        frame_dt = max(ts - t_prev, 0.0)
        self._last_prop_time = ts
        return gyro, accel, dts, frame_dt

    def _pack_meas(self, ids, xpd):
        """The frame's point measurements padded to MEAS_CAP; with more,
        the measurements of live tracks first (the reference's rule)."""
        mid = np.full((MEAS_CAP,), -1, np.int64)
        mxp = np.zeros((MEAS_CAP, 2))
        mdepth = np.full((MEAS_CAP,), -1.0)
        mvalid = np.zeros((MEAS_CAP,), np.int64)
        n = min(len(ids), MEAS_CAP)
        if len(ids) > MEAS_CAP:
            # keep measurements of existing tracks first
            live = set(_np(self.state.features.fid).tolist())
            pri = np.argsort([0 if int(i) in live else 1 for i in ids],
                             kind="stable")[:MEAS_CAP]
            ids, xpd = np.asarray(ids)[pri], xpd[pri]
        mid[:n] = np.asarray(ids[:n], np.int32)
        mxp[:n] = xpd[:n, :2]
        mdepth[:n] = xpd[:n, 2]
        mvalid[:n] = 1
        return mid, mxp, mdepth, mvalid

    def _upload_frame(self, imu, meas=None):
        """One frame's inputs on the device, floats in one copy and
        integers in another: ([gyro (1, K, 3), accel, dts (1, K),
        frame_dt (1,)] + [meas_xp (1, M, 2), meas_depth (1, M)],
        [meas_id (1, M), meas_valid (1, M)])."""
        parts = list(imu)
        if meas is not None:
            parts += [meas[1], meas[2]]
        host = [self._host(p) for p in parts]
        flat = self._upload(np.concatenate([h.ravel() for h in host]))
        out, o = [], 0
        for h in host:
            out.append(flat[o:o + h.size].view((1,) + h.shape))
            o += h.size
        if meas is None:
            return out, ()
        ints = self._upload(np.concatenate([meas[0], meas[3]]))
        return out, (ints[None, :MEAS_CAP], ints[None, MEAS_CAP:] != 0)

    def _frame_cfg(self, dts, frame_dt) -> VIOConfig:
        """The config with its substep cap sized to the frame's intervals
        (module docstring); the substep counters are zeroed before the
        estimator's first frame."""
        if propagate.uses_substep_loop(self.cfg) and not self._counting:
            propagate.reset_substep_counts(self.device)
            self._counting = True
        return R.fit_substeps(self.cfg, SimpleNamespace(
            imu_dt=self._host(dts), frame_dt=self._host([frame_dt])))

    def _draws(self, mapped=False):
        """The frame's (homography, P3P) draws (``runner.frame_draws``)."""
        return R.frame_draws(self.cfg, self.state, self._gen, mapped)

    def _run_frame(self, ts, imu, ids, xpd):
        gyro, accel, dts, frame_dt = self._pack_imu(ts, imu)
        cfg = self._frame_cfg(dts, frame_dt)
        f, i = self._upload_frame((gyro, accel, dts, [frame_dt]),
                                  self._pack_meas(ids, xpd))
        f[3] = f[3][0]                 # frame_dt (1,)
        hom, p3p = self._draws(self._map is not None)
        if self._map is not None:
            self.state, self._map, out, self._last_n_lc = vio_frame_mapped(
                cfg, self.state, self._map, *f[:4], i[0], f[4], f[5], i[1],
                p3p, hom)
        else:
            self.state, out = vio_frame(cfg, self.state, *f[:4], i[0], f[4],
                                        f[5], i[1], hom)
        self._last_out = out

    def _run_image_frame(self, ts, imu, image):
        gyro, accel, dts, frame_dt = self._pack_imu(ts, imu)
        cfg = self._frame_cfg(dts, frame_dt)
        f, _ = self._upload_frame((gyro, accel, dts, [frame_dt]))
        f[3] = f[3][0]
        img = self._upload(image)[None]
        hom, p3p = self._draws(self._map is not None)
        if self._map is not None:
            (self.state, self._fes, self._map, out,
             self._last_n_lc) = vio_frame_image_mapped(
                cfg, self.state, self._fes, self._map, *f, img, p3p, hom)
        else:
            self.state, self._fes, out = vio_frame_image(
                cfg, self.state, self._fes, *f, img, hom)
        self._last_out = out

    # ------------------------------------------------------------------
    # accessors (pyxivo parity, pybind11/pyxivo.cpp:332-398)
    # ------------------------------------------------------------------

    def gsb(self):
        X = self.state.X
        return _np(X.Rsb), _np(X.Tsb)

    def gbc(self):
        X = self.state.X
        return _np(X.Rbc), _np(X.Tbc)

    def gsc(self):
        Rsb, Tsb = self.gsb()
        Rbc, Tbc = self.gbc()
        return Rsb @ Rbc, Rsb @ Tbc + Tsb

    def Vsb(self):
        return _np(self.state.X.Vsb)

    def bg(self):
        return _np(self.state.X.bg)

    def ba(self):
        return _np(self.state.X.ba)

    def Rg(self):
        return _np(self.state.X.Rsg)

    def td(self):
        return float(self.state.X.td[0])

    def Ca(self):
        return _np(self.state.X.Ca)

    def Cg(self):
        return _np(self.state.X.Cg)

    def _P_full(self):
        """Dense covariance regardless of representation (sqrt mode
        stores the factor; accessors expose P = S S^T)."""
        P = _np(self.state.P)
        if P.shape[0] != P.shape[1]:
            P = P @ P.T
        return P

    def Pstate(self):
        return self._P_full()[:L.MOTION, :L.MOTION]

    def P(self):
        return self._P_full()

    def camera_intrinsics(self):
        return _np(self.state.cam)

    def now(self):
        return self._last_prop_time

    def num_instate_features(self):
        return int((_np(self.state.features.sind) >= 0).sum())

    def num_instate_groups(self):
        return int((_np(self.state.groups.sind) >= 0).sum())

    def _out(self, field, cast=int, default=0):
        o = self._last_out
        return cast(getattr(o, field)[0]) if o is not None else default

    def num_tracked_features(self):
        return self._out("num_tracked")

    def num_mh_rejected(self):
        return self._out("num_mh_rejected")

    def inn_rms(self):
        return self._out("inn_rms", float, 0.0)

    def num_loop_closure_rows(self):
        """Closure rows the last mapped frame applied (0 before one)."""
        n = self._last_n_lc
        return int(n[0]) if n is not None else 0

    def InstateFeaturePositions(self):
        """Spatial positions of instate features (+ ids)."""
        fr = self.state.features
        gr = self.state.groups
        sel = _np(fr.sind) >= 0
        x = _np(fr.x)[sel]
        ref = _np(fr.ref)[sel]
        Rbc, Tbc = self.gbc()
        g_R, g_T = _np(gr.Rsb), _np(gr.Tsb)
        Xs = []
        for xi, ri in zip(x, ref):
            z = np.exp(xi[2])
            Xc = np.array([xi[0] * z, xi[1] * z, z])
            Xs.append(g_R[ri] @ (Rbc @ Xc + Tbc) + g_T[ri])
        ids = _np(fr.fid)[sel]
        return np.asarray(Xs).reshape(-1, 3), ids

    def InstateGroupPoses(self):
        gr = self.state.groups
        sel = _np(gr.sind) >= 0
        return (_np(gr.Rsb)[sel], _np(gr.Tsb)[sel], _np(gr.gid)[sel])

    # -- remaining pyxivo surface (pybind11/pyxivo.cpp:332-398) --------

    def _instate_rows(self):
        sind = _np(self.state.features.sind)
        rows = np.nonzero(sind >= 0)[0]
        return rows[np.argsort(sind[rows])]

    def InstateFeatureIDs(self):
        return _np(self.state.features.fid)[self._instate_rows()]

    def InstateFeatureSinds(self):
        return _np(self.state.features.sind)[self._instate_rows()]

    def InstateFeatureRefGroups(self):
        fr = self.state.features
        rows = self._instate_rows()
        return _np(self.state.groups.gid)[_np(fr.ref)[rows]]

    def InstateFeatureXc(self):
        """3D positions in the reference camera frame."""
        x = _np(self.state.features.x)[self._instate_rows()]
        z = np.exp(x[:, 2])
        return np.stack([x[:, 0] * z, x[:, 1] * z, z], axis=1)

    def InstateFeaturexc(self):
        """Local parametrization (X/Z, Y/Z, log Z)."""
        return _np(self.state.features.x)[self._instate_rows()]

    def InstateFeatureCovs(self):
        """Per-feature 3x3 blocks of the big covariance."""
        d = self.cfg.dims
        P = self._P_full()
        sind = _np(self.state.features.sind)
        out = []
        for row in self._instate_rows():
            off = d.feature_off(int(sind[row]))
            out.append(P[off:off + 3, off:off + 3])
        return np.asarray(out).reshape(-1, 3, 3)

    def InstateFeaturePreds(self):
        return _np(self.state.features.pred)[self._instate_rows()]

    def InstateFeatureMeas(self):
        return _np(self.state.features.xp)[self._instate_rows()]

    def InstateGroupIDs(self):
        gr = self.state.groups
        return _np(gr.gid)[_np(gr.sind) >= 0]

    def InstateGroupSinds(self):
        sind = _np(self.state.groups.sind)
        return sind[sind >= 0]

    def InstateGroupCovs(self):
        P = self._P_full()
        out = []
        for sl in self.InstateGroupSinds():
            off = L.GROUP_BEGIN + 6 * int(sl)
            out.append(P[off:off + 6, off:off + 6])
        return np.asarray(out).reshape(-1, 6, 6)

    def gauge_group(self):
        row = int(self.state.gauge_row[0])
        if row < 0:
            return -1
        return int(_np(self.state.groups.gid)[row])

    def CameraIntrinsics(self):
        return _np(self.state.cam)

    def CameraDistortionType(self):
        return self.cfg.cam_model

    def MeasurementUpdateInitialized(self):
        return self._last_out is not None

    def VisionInitialized(self):
        return self.vision_initialized

    def UsingLoopClosure(self):
        return self.cfg.use_mapper

    def num_oneptransac_rejected(self):
        return self._out("num_oneptransac_rejected")

    def num_tracker_outlier_rejected(self):
        """Homography-RANSAC rejects this frame (Tracker counter
        parity, src/tracker.h:47-51 via pyxivo.cpp:332-398)."""
        return self._out("num_tracker_outlier_rejected")

    def num_tracker_failed_to_track(self):
        return int((_np(self.state.features.track) == TS_DROPPED).sum())

    def num_tracker_new_detections(self):
        return int((_np(self.state.features.track) == TS_CREATED).sum())

    def JustDroppedFeatureIDs(self):
        fr = self.state.features
        return _np(fr.fid)[_np(fr.track) == TS_DROPPED]

    def tracked_features(self):
        """(id, x, y) of live tracks + descriptors."""
        fr = self.state.features
        fid = _np(fr.fid)
        sel = (fid >= 0) & (_np(fr.track) == TS_TRACKED)
        return (fid[sel], _np(fr.xp)[sel],
                _np(fr.desc)[sel].astype(np.uint32))

    def tracked_features_no_descriptor(self):
        fid, xp, _ = self.tracked_features()
        return fid, xp

    def Visualize(self, save_path: Optional[str] = None,
                  live: bool = False, img=None):
        """Static track canvas, or — with live=True — an incremental 3D
        trajectory/frustum/landmark view (Viewer::Refresh parity,
        src/viewer.h:17-49) that persists across calls."""
        if live:
            if self._live_viewer is None:
                from ..viz_live import LiveViewer
                p = self.cfg.cam_params
                self._live_viewer = LiveViewer(
                    name=self.name or "xivo_tpu_torch",
                    imh=int(p[0]), imw=int(p[1]), fx=float(p[2]),
                    fy=float(p[3]), cx=float(p[4]), cy=float(p[5]))
            self._live_viewer.update_from_estimator(self, img=img)
            if save_path:
                self._live_viewer.save_frame(save_path)
            return self._live_viewer
        from ..viz import plot_tracks
        return plot_tracks(self, save_path)

    def CloseLoop(self):
        """Explicit loop-closure step against the accumulated map.

        When use_mapper is on, the per-frame step already closes loops
        (vio_frame_mapped); this triggers an extra pass — the
        `est->CloseLoop()` call of the vio app (src/app/vio.cpp:75-77).
        It takes its RANSAC draws from the estimator's generator.
        """
        if not self.cfg.use_mapper or self._map is None:
            return 0
        from ..map.mapper import close_loop
        cfg = self.cfg
        self.state, n = close_loop(
            cfg, self.state, self._map,
            R.p3p_draws(cfg, self.state, self._gen),
            nn_dist_thresh=cfg.lc_nn_dist_thresh,
            ransac_thresh=cfg.lc_ransac_thresh,
            min_matches=cfg.lc_min_matches)
        return int(n[0])

    # -- checkpoint / resume (absent in the reference; SURVEY §5 names
    #    it as a required first-class improvement) ----------------------

    def save_checkpoint(self, path: str):
        """Pickle the estimator to `path`: the filter, front-end and map
        states as the port's NamedTuples with numpy leaves (``interop``'s
        ``*_to_numpy``, batch axis of 1 kept), the generator's state, and
        the JAX package's host-side meta. This is the port's own format:
        the JAX package pickles its own state classes, which the port
        cannot load without importing that package, and it cannot load
        these."""
        import pickle
        blob = dict(
            state=interop.state_to_numpy(self.state),
            fes=interop.frontend_to_numpy(self._fes)
            if self._fes is not None else None,
            map=interop.map_to_numpy(self._map)
            if self._map is not None else None,
            generator=self._gen.get_state().numpy(),
            meta=dict(gravity_initialized=self.gravity_initialized,
                      vision_initialized=self.vision_initialized,
                      last_prop_time=self._last_prop_time,
                      pending_imu=self._pending_imu,
                      grav_buf=self._grav_buf,
                      reorder_buf=list(self._buf),
                      clock=self._clock,
                      n_misordered=self._n_misordered_dropped))
        with open(path, "wb") as f:
            pickle.dump(blob, f)

    def load_checkpoint(self, path: str):
        import pickle
        with open(path, "rb") as f:
            blob = pickle.load(f)
        self.state = interop.state_from_numpy(blob["state"], self.device)
        if blob["fes"] is not None:
            self._fes = interop.frontend_from_numpy(blob["fes"], self.device)
        if blob["map"] is not None:
            self._map = interop.map_from_numpy(blob["map"], self.device)
        self._gen.set_state(torch.from_numpy(blob["generator"]))
        m = blob["meta"]
        self.gravity_initialized = m["gravity_initialized"]
        self.vision_initialized = m["vision_initialized"]
        self._last_prop_time = m["last_prop_time"]
        self._pending_imu = m["pending_imu"]
        self._grav_buf = m["grav_buf"]
        self._buf = list(m["reorder_buf"])
        heapq.heapify(self._buf)
        self._clock = m["clock"]
        self._n_misordered_dropped = m["n_misordered"]
