"""The point-cloud-world entry: B sequences through the program's
``runner.run_batch``, called once a frame so that the window can close
between frames and mark each frame's end on the device.

Set-up makes the traffic's S world streams on the host, noise-free,
with the benchmark's frozen generator; the seed sets which stream each
row takes (each B / S rows) and draws each row's own pixel and IMU noise
on the device. A
job is B fresh sequences of the stream's T frames.
"""
from __future__ import annotations

import torch

from xivo_tpu_torch.filter.config import config_from_json
from xivo_tpu_torch.filter.layout import Dims
from xivo_tpu_torch.filter.state import tree_map
from xivo_tpu_torch.runner import (FrameInputs, batch_states,
                                   inputs_to_device, run_batch)

from ..gen.streams import PCW_FIELDS, build_pcw_stream
from . import common

# the stage functions the per-layer metrics time and range, by role
STAGES = {"propagate": "xivo_tpu_torch.filter.pipeline:propagate_frame",
          "update": "xivo_tpu_torch.filter.pipeline:update_step",
          "pointcloud_tracker":
              "xivo_tpu_torch.filter.pipeline:tracker_pointcloud"}


def program_config(spec):
    dims = Dims(**spec["dims"]) if spec["dims"] else None
    return config_from_json(spec["filter"], dims=dims, **spec["run_options"])


def make_streams(spec, traffic, frames=None):
    cam, X = spec["filter"]["camera_cfg"], spec["filter"]["X"]
    streams = [build_pcw_stream(cam, X["Wbc"], X["Tbc"], noise_px=0.0,
                                noise_accel=0.0, noise_gyro=0.0,
                                world_seed=ws, **traffic["generator"])
               for ws in traffic["world_seeds"]]
    if frames is not None:
        streams = [({k: v[:frames] for k, v in fi.items()},
                    dict(gt, Tsb=gt["Tsb"][:frames], Rsb=gt["Rsb"][:frames]))
                   for fi, gt in streams]
    return streams


class Cell:
    fields = PCW_FIELDS

    def __init__(self, spec, traffic, seed, device, batch=None,
                 frames=None):
        self.cfg = program_config(spec)
        self.B = B = batch or spec["batch"]
        streams = make_streams(spec, traffic, frames)
        S = len(streams)
        dev = inputs_to_device(FrameInputs(**common.stack_streams(
            streams, PCW_FIELDS)), device)
        row_stream = common.row_streams(seed, B, S, device)
        fi = FrameInputs(*(common.rows_of(a, row_stream) for a in dev))
        gen = common.noise_generator(seed, device)
        nz, imu = traffic["noise"], fi.imu_dt > 0
        self.inputs = fi._replace(
            gyro=common.add_noise(fi.gyro, nz["gyro"], imu, gen),
            accel=common.add_noise(fi.accel, nz["accel"], imu, gen),
            meas_xp=common.add_noise(fi.meas_xp, nz["px"], fi.meas_valid,
                                     gen))
        self.T = int(fi.frame_dt.shape[1])
        self.gt_Tsb, self.gyro0, self.accel0 = common.gt_rows(
            streams, row_stream, device)
        s = batch_states(self.cfg, B, device)
        self.init = s._replace(last_gyro=self.gyro0.to(device, s.P.dtype),
                               last_accel=self.accel0.to(device, s.P.dtype))

    def fresh(self):
        """A new job's carry: B fresh states."""
        return tree_map(torch.clone, self.init)

    def step(self, carry, t):
        """Frame t of the job: (carry, StepOutputs (B, 1, ...))."""
        fi = FrameInputs(*(a[:, t:t + 1] for a in self.inputs))
        return run_batch(self.cfg, carry, fi, seed=t)

    def rows(self, rows):
        """The inputs of `rows` (a (R,) int64 tensor) as the reference
        takes them: {field: (R, T, ...)}, gyro0 and accel0 (R, 3)."""
        r = rows.to(self.inputs.frame_dt.device)
        return ({f: getattr(self.inputs, f).index_select(0, r)
                 for f in PCW_FIELDS},
                self.gyro0.index_select(0, rows.cpu()),
                self.accel0.index_select(0, rows.cpu()))
