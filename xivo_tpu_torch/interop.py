"""Carry state between the JAX package and this port.

``state_from_numpy`` takes the JAX package's ``VIOState`` with its leaves
as numpy arrays (``jax.tree.map(np.asarray, s)``), batched or not, and
builds the port's state; ``state_to_numpy`` goes back to numpy with the
reference's dtypes (int32 indices, uint32 descriptors). Fields are matched
by name; the reference's PRNG ``key`` has no counterpart and is skipped
(the port takes its RANSAC draws as an argument). ``map_*``,
``bigmap_*`` and ``frontend_*`` do the same for the sparse map, the
map with observations and the image front end's state. Every
``*_from_numpy`` puts its tensors on the card unless given
``device="cpu"``. Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .filter.state import FeatureTable, GroupTable, MotionState, VIOState
from .frontend.tracker import FrontendState
from .map.bigmap import BigMapState
from .map.mapper import MapState

_NESTED = {"X": MotionState, "features": FeatureTable, "groups": GroupTable}


def _to_tensor(a, device):
    a = np.asarray(a)
    if a.dtype.kind in "iu":
        return torch.as_tensor(a.astype(np.int64), device=device)
    return torch.from_numpy(np.array(a)).to(device)


def _from_numpy(cls, src, device):
    """Build the port's NamedTuple cls from the reference's (numpy leaves),
    field by field, by name."""
    dev = resolve_device(device)

    def build(cls, src):
        return cls(*(build(_NESTED[name], getattr(src, name))
                     if name in _NESTED
                     else _to_tensor(getattr(src, name), dev)
                     for name in cls._fields))
    return build(cls, src)


def _to_numpy(tree):
    """The port's NamedTuple -> the same structure with numpy leaves in the
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
    return build(tree)


def state_from_numpy(ns, device="cuda") -> VIOState:
    """The reference's VIOState (numpy leaves) -> the port's VIOState."""
    return _from_numpy(VIOState, ns, device)


def state_to_numpy(s: VIOState) -> VIOState:
    return _to_numpy(s)


def map_from_numpy(nm, device="cuda") -> MapState:
    """The reference's MapState (numpy leaves) -> the port's."""
    return _from_numpy(MapState, nm, device)


def map_to_numpy(ms: MapState) -> MapState:
    return _to_numpy(ms)


def bigmap_from_numpy(nb, device="cuda") -> BigMapState:
    """The reference's BigMapState (numpy leaves) -> the port's."""
    return _from_numpy(BigMapState, nb, device)


def bigmap_to_numpy(bm: BigMapState) -> BigMapState:
    return _to_numpy(bm)


def frontend_from_numpy(nf, device="cuda") -> FrontendState:
    """The reference's FrontendState (numpy leaves) -> the port's."""
    dev = resolve_device(device)
    return FrontendState(
        pyr=tuple(torch.from_numpy(np.array(p)).to(dev) for p in nf.pyr),
        initialized=torch.from_numpy(np.array(nf.initialized)).to(dev))


def frontend_to_numpy(fes: FrontendState) -> FrontendState:
    """The port's FrontendState -> numpy leaves."""
    return FrontendState(
        pyr=tuple(p.detach().cpu().numpy() for p in fes.pyr),
        initialized=fes.initialized.detach().cpu().numpy())
