"""Error-state retraction: nominal state (+) error vector (port of
``xivo_tpu/filter/retraction.py``; State::operator+=, src/core.h:135-165).
Broadcasts over leading dimensions."""
from __future__ import annotations

import torch

from ..geom import so3
from . import layout as L
from .state import MotionState


def apply_motion_error(X: MotionState, err) -> MotionState:
    """err: (..., MOTION) tangent update; right-multiplicative rotations."""
    wsg = torch.cat([err[..., L.WSG:L.WSG + 2],
                     torch.zeros_like(err[..., :1])], dim=-1)
    return MotionState(
        Rsb=so3.project(X.Rsb @ so3.exp(err[..., L.WSB:L.WSB + 3])),
        Tsb=X.Tsb + err[..., L.TSB:L.TSB + 3],
        Vsb=X.Vsb + err[..., L.VSB:L.VSB + 3],
        bg=X.bg + err[..., L.BG:L.BG + 3],
        ba=X.ba + err[..., L.BA:L.BA + 3],
        Rbc=so3.project(X.Rbc @ so3.exp(err[..., L.WBC:L.WBC + 3])),
        Tbc=X.Tbc + err[..., L.TBC:L.TBC + 3],
        Rsg=so3.project(X.Rsg @ so3.exp(wsg)),
        td=X.td + err[..., L.TD],
        Cg=X.Cg + err[..., L.CG:L.CG + 9].reshape(err.shape[:-1] + (3, 3)),
        Ca=X.Ca + so3.upper_tri_from6(err[..., L.CA:L.CA + 6]))


def apply_camera_error(intrin, err_cam):
    """Camera intrinsics update (A_*Camera::UpdateState parity)."""
    return intrin + err_cam


def apply_group_error(Rsb, Tsb, err6):
    """Group pose tangent update (src/group.h:24-30)."""
    return (so3.project(Rsb @ so3.exp(err6[..., :3])),
            Tsb + err6[..., 3:6])
