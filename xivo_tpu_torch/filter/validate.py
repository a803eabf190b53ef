"""State invariant validation, a debugging tool (port of
``xivo_tpu/filter/validate.py``).

The masked-table form of the reference's Graph::SanityCheck and of its
bookkeeping CHECKs (src/graph.h:77-86, src/manager.cpp:49-100):
assertions on the host over numpy copies of one sequence's state. Not on
any frame path: it reads the state back from the device.
"""
from __future__ import annotations

import numpy as np

from .config import VIOConfig
from .state import FS_GAUGE, FS_INSTATE, TS_CREATED, VIOState


def validate_state(cfg: VIOConfig, s: VIOState, seq: int = None) -> list:
    """The violated invariants of one sequence's state, as descriptions
    (empty: all hold). `s` is that sequence's state, or a batched state
    with `seq` the sequence to check."""
    def host(t):
        a = t.detach().cpu().numpy()
        return a if seq is None else a[seq]

    errs = []
    fr, gr = s.features, s.groups
    fid, fsind, fref = host(fr.fid), host(fr.sind), host(fr.ref)
    status, track = host(fr.status), host(fr.track)
    gid, gsind = host(gr.gid), host(gr.sind)
    f2row, g2row = host(s.f2row), host(s.g2row)
    P = host(s.P)
    if P.shape[0] != P.shape[1]:   # a square-root factor: P = S S^T
        P = P @ P.T
    d = cfg.dims

    # the slot maps invert sind
    for slot, row in enumerate(f2row):
        if row >= 0 and fsind[row] != slot:
            errs.append(f"f2row[{slot}]={row} but sind[{row}]={fsind[row]}")
    for slot, row in enumerate(g2row):
        if row >= 0 and gsind[row] != slot:
            errs.append(f"g2row[{slot}]={row} but sind[{row}]={gsind[row]}")
    # instate features: active, on a slot, anchored to an instate group
    inst = fsind >= 0
    if np.any(inst & (fid < 0)):
        errs.append("instate feature on inactive row")
    bad_ref = inst & ((fref < 0) | (gsind[np.clip(fref, 0, len(gid) - 1)]
                                    < 0))
    if np.any(bad_ref):
        errs.append(f"instate features with non-instate refs: "
                    f"{np.nonzero(bad_ref)[0].tolist()}")
    if np.any(inst & ~np.isin(status, [FS_INSTATE, FS_GAUGE])):
        errs.append("instate feature with non-instate status")
    if np.any(~inst & np.isin(status, [FS_INSTATE, FS_GAUGE]) & (fid >= 0)):
        errs.append("non-instate feature carries instate status")
    # every active feature but a just-created track references a live group
    ref_ok = (fref >= 0) & (gid[np.clip(fref, 0, len(gid) - 1)] >= 0)
    if np.any((fid >= 0) & (track != TS_CREATED) & ~ref_ok):
        errs.append("active feature referencing dead group row")
    # covariance: finite, symmetric, zero on freed slots
    if not np.isfinite(P).all():
        errs.append("non-finite covariance")
    if not np.allclose(P, P.T, atol=1e-6):
        errs.append("asymmetric covariance")
    for slot in range(d.n_features):
        if f2row[slot] < 0:
            off = d.feature_off(slot)
            if np.abs(P[off:off + 3]).max() > 0:
                errs.append(f"freed feature slot {slot} has nonzero cov")
    for slot in range(d.n_groups):
        if g2row[slot] < 0:
            off = d.group_off(slot)
            if np.abs(P[off:off + 6]).max() > 0:
                errs.append(f"freed group slot {slot} has nonzero cov")
    return errs
