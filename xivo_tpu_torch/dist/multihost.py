"""Multi-process execution on ``torch.distributed`` (port of
``xivo_tpu/dist/multihost.py``).

The reference's process-spanning JAX mesh becomes a process group: each
rank owns one device (``cuda:<local rank>`` with NCCL, the CPU with
gloo), and the layouts that ``shard_map`` gives (a leaf split along its
leading axis over the mesh) become explicit collectives.

* ``init_distributed`` brings the group up from arguments or the
  XIVO_COORDINATOR / XIVO_NUM_PROCESSES / XIVO_PROCESS_ID variables and
  returns False, doing nothing, for a single process;
* ``global_mesh`` returns the world group, bringing up a one-rank group
  where none is up, so that a single process runs the same collectives;
  the factories below take it where they are given no group;
* ``host_local_to_global`` gathers every rank's (B_local, ...) leaves
  into the (B_local n, ...) batch, rank by rank; ``global_to_host_local``
  keeps the rank's rows of a global batch;
* ``make_multihost_runner`` runs each rank's own sequences through the
  batch runner and returns them host-local: the filter makes no
  collective. ``runner.make_sharded_runner`` is this run between
  ``global_to_host_local`` and ``host_local_to_global``.

NCCL takes contiguous tensors on the rank's device; gloo takes no bool,
so bool leaves travel as uint8. A collective on a CUDA tensor needs an
NCCL group and one on a CPU tensor a gloo group: nothing falls back.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import socket
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import runner as R
from ..filter.state import tree_map

TIMEOUT_S = 300          # a collective that waits longer raises; read when
                         # a group is brought up


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids=None,
                     backend: Optional[str] = None) -> bool:
    """Bring up the process group of `num_processes` ranks that meet at
    `coordinator_address` ("host:port"), this process being rank
    `process_id`. Arguments left out fall back to XIVO_COORDINATOR,
    XIVO_NUM_PROCESSES and XIVO_PROCESS_ID; with fewer than two processes
    nothing is brought up and False is returned. `backend` defaults to
    NCCL on ``cuda:<local device>``, the first of `local_device_ids` or
    the rank modulo the cards of this host; NCCL without CUDA raises.
    Returns True."""
    coordinator_address = coordinator_address \
        or os.environ.get("XIVO_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("XIVO_NUM_PROCESSES", "0")) or None
    if process_id is None:
        pid = os.environ.get("XIVO_PROCESS_ID")
        process_id = int(pid) if pid is not None else None
    if not coordinator_address or not num_processes or num_processes < 2:
        return False
    if process_id is None:
        raise ValueError("a multi-process group needs the process id")
    _init(f"tcp://{coordinator_address}", num_processes, process_id,
          backend, local_device_ids)
    return True


def _init(init_method, world, rank, backend, local_device_ids):
    backend = backend or "nccl"
    kw = {}
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the NCCL backend needs CUDA; pass "
                               "backend='gloo' to run on the CPU")
        local = (local_device_ids[0] if local_device_ids
                 else rank % torch.cuda.device_count())
        kw["device_id"] = torch.device("cuda", local)
        torch.cuda.set_device(local)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S), **kw)


def global_mesh(backend: Optional[str] = None):
    """The world group. Where none is up, a one-rank group of this
    process is brought up first (on a free port of 127.0.0.1, `backend`
    as in ``init_distributed``), so that the collectives run at n = 1.
    A `backend` other than that of the group already up raises."""
    if not dist.is_initialized():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        _init(f"tcp://127.0.0.1:{port}", 1, 0, backend, None)
    elif backend is not None and str(dist.get_backend()) != backend:
        raise RuntimeError(f"a {dist.get_backend()} group is up, not "
                           f"{backend}")
    return dist.group.WORLD


def rank_rows(n_rows: int, group=None):
    """(lo, hi): the rows of an axis of n_rows that this rank holds, the
    r-th of n equal parts; ValueError unless n divides n_rows."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if n_rows % n:
        raise ValueError(f"{n_rows} rows do not split over {n} ranks")
    k = n_rows // n
    return r * k, (r + 1) * k


def check_backend(group, t: torch.Tensor):
    """Raise unless the group's backend takes tensors on t's device: NCCL
    for CUDA, gloo for the CPU."""
    want = "nccl" if t.device.type == "cuda" else "gloo"
    got = str(dist.get_backend(group))
    if got != want:
        raise RuntimeError(f"a {t.device.type} tensor needs a {want} "
                           f"group, this one is {got}")


def all_gather_dim(t: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's t joined along `dim`, rank by rank."""
    check_backend(group, t)
    n = dist.get_world_size(group)
    wire = t.to(torch.uint8) if t.dtype == torch.bool else t
    wire = wire.movedim(dim, 0).contiguous()
    parts = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire, group=group)
    out = torch.cat(parts, 0).movedim(0, dim)
    return out.to(torch.bool) if t.dtype == torch.bool else out


def host_local_to_global(tree, group=None):
    """Each rank's (B_local, ...) leaves -> the (n B_local, ...) batch,
    rank 0's rows first, on every rank."""
    return tree_map(lambda x: all_gather_dim(x, 0, group), tree)


def global_to_host_local(tree, group=None):
    """A global (B, ...) batch -> this rank's rows (``rank_rows``)."""
    def mine(x):
        lo, hi = rank_rows(x.shape[0], group)
        return x[lo:hi]
    return tree_map(mine, tree)


def make_multihost_runner(cfg, group=None):
    """The batch runner on host-local rows, over `group` (``global_mesh()``
    without one): run(states, fis, seed=0, check=True) takes this rank's
    (B_local, ...) states, on its device, and inputs (numpy, or tensors on
    that device), and returns its final states and outputs. The ranks'
    rows joined are the global batch, and the result is the global run's
    rows: the homography draws are cut from the global batch's, and with
    numpy inputs the substep cap is the largest any rank's stream needs
    (one all_reduce and one read of it before the frames). Every rank
    holds B_local rows."""
    group = global_mesh() if group is None else group

    def run(states, fis, seed: int = 0, check: bool = True):
        B = states.P.shape[0]
        n, r = dist.get_world_size(group), dist.get_rank(group)
        dev = states.P.device
        c = cfg
        if isinstance(fis.frame_dt, np.ndarray):
            c = R.fit_substeps(cfg, fis)
            cap = torch.tensor([c.max_substeps], dtype=torch.int64,
                               device=dev)
            check_backend(group, cap)
            dist.all_reduce(cap, op=dist.ReduceOp.MAX, group=group)
            c = dataclasses.replace(c, max_substeps=int(cap[0]))
            fis = R.inputs_to_device(fis, dev)
        return R.run_batch(c, states, fis, check=check, seed=seed,
                           rows=(r * B, n * B))
    return run
