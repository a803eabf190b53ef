"""Carry filter state between the JAX package and this port.

``state_from_numpy`` takes the JAX package's ``VIOState`` with its leaves
as numpy arrays (``jax.tree.map(np.asarray, s)``), batched or not, and
builds the port's state; ``state_to_numpy`` goes back to numpy with the
reference's dtypes (int32 indices, uint32 descriptors). Fields are matched
by name; the reference's PRNG ``key`` has no counterpart and is skipped.
``frontend_from_numpy``/``frontend_to_numpy`` do the same for the image
front end's state (the previous pyramid). Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .filter.state import FeatureTable, GroupTable, MotionState, VIOState
from .frontend.tracker import FrontendState

_NESTED = {"X": MotionState, "features": FeatureTable, "groups": GroupTable}


def _to_tensor(a, device):
    a = np.asarray(a)
    if a.dtype.kind in "iu":
        return torch.as_tensor(a.astype(np.int64), device=device)
    return torch.from_numpy(np.array(a)).to(device)


def state_from_numpy(ns, device="cpu") -> VIOState:
    """The reference's VIOState (numpy leaves) -> the port's VIOState."""
    def build(cls, src):
        vals = []
        for name in cls._fields:
            v = getattr(src, name)
            vals.append(build(_NESTED[name], v) if name in _NESTED
                        else _to_tensor(v, device))
        return cls(*vals)
    return build(VIOState, ns)


def state_to_numpy(s: VIOState) -> VIOState:
    """The port's state -> the same structure with numpy leaves in the
    reference's dtypes."""
    def conv(name, t):
        a = t.detach().cpu().numpy()
        if name == "desc":
            return a.astype(np.uint32)
        if a.dtype == np.int64:
            return a.astype(np.int32)
        return a

    def build(tree):
        return type(tree)(*(build(v) if isinstance(v, tuple) else conv(k, v)
                            for k, v in zip(tree._fields, tree)))
    return build(s)


def frontend_from_numpy(nf, device="cpu") -> FrontendState:
    """The reference's FrontendState (numpy leaves) -> the port's."""
    return FrontendState(
        pyr=tuple(torch.from_numpy(np.array(p)).to(device) for p in nf.pyr),
        initialized=torch.from_numpy(np.array(nf.initialized)).to(device))


def frontend_to_numpy(fes: FrontendState) -> FrontendState:
    """The port's FrontendState -> numpy leaves."""
    return FrontendState(
        pyr=tuple(p.detach().cpu().numpy() for p in fes.pyr),
        initialized=fes.initialized.detach().cpu().numpy())
