"""Distributed bundle adjustment over a process group (port of
``xivo_tpu/dist/ba.py``; its docstring gives the design).

The landmarks (axis 1 of the batched ``BAProblem``) are split over the
group's ranks and the poses are replicated. Each rank builds the normal
equations of its landmarks and eliminates them (``ba.core``'s pieces);
four SUM all-reduces add up U, S_red, b and chi2. The dense (6K, 6K)
solve is replicated (``ba.core.solve_reduced``, the reference's
``_assemble_and_solve``, by ``torch.linalg.cholesky_ex`` /
``cholesky_solve``), the landmark back-substitution stays on the
rank, and the accept test reads the all-reduced chi2 and active counts,
so every rank takes the same branch. No collective reads anything back
to the host.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from ..ba.core import (BAProblem, apply_step, chi2_only, levenberg_marquardt,
                       normal_blocks, solve_reduced)
from .multihost import check_backend, global_mesh, rank_rows


def _sum(t: torch.Tensor, group) -> torch.Tensor:
    check_backend(group, t)
    t = t.contiguous()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _local_reduction(p_shard: BAProblem, lam, huber_thresh: float, group):
    """The normal equations of this rank's landmarks, summed over the
    group: (U, S_red, b_red, chi2 (B,)) and this rank's (W, Vinv, bl)."""
    U, S_red, b_red, chi2, back = normal_blocks(p_shard, lam, huber_thresh)
    return (_sum(U, group), _sum(S_red, group), _sum(b_red, group),
            _sum(chi2, group), back)


def _local_chi2(p_shard: BAProblem, huber_thresh: float, group):
    c, n = chi2_only(p_shard, huber_thresh)
    return _sum(c, group), _sum(n, group)


def make_distributed_solver(group=None, iters: int = 10,
                            damping: float = 1e-4,
                            huber_thresh: float = 1e9):
    """Returns solve(p_shard) -> (p_shard refined, chi2 history (B,
    iters)): ``ba.core.solve`` with this rank's landmarks
    (``shard_problem``) and the landmark sums all-reduced over `group`
    (``global_mesh()`` without one). The poses and the history are the
    same on every rank."""
    group = global_mesh() if group is None else group

    def iteration(p: BAProblem, lam):
        lam = lam.to(p.Xs.dtype)
        U, S_red, b_red, chi2, back = _local_reduction(p, lam, huber_thresh,
                                                       group)
        dp = solve_reduced(p.fixed, U, S_red, b_red, lam)
        return apply_step(p, dp, *back), chi2

    def solve(p_shard: BAProblem) -> Tuple[BAProblem, torch.Tensor]:
        return levenberg_marquardt(
            p_shard, iters, damping, iteration,
            lambda q: _local_chi2(q, huber_thresh, group))
    return solve


def shard_problem(p: BAProblem, group=None) -> BAProblem:
    """This rank's part of a problem: its Lm/n landmarks (Xs, obs, mask
    along axis 1) and every pose. Lm must divide by n."""
    lo, hi = rank_rows(p.Xs.shape[1], group)
    return p._replace(Xs=p.Xs[:, lo:hi], obs=p.obs[:, lo:hi],
                      mask=p.mask[:, lo:hi])

