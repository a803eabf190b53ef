"""Sharded loop-closure retrieval (port of ``xivo_tpu/dist/retrieval.py``).

The map's descriptor table is split over the ranks of a process group:
each rank scores its slice with B6 (``ops/hamming.hamming_nn``, the
hand-written kernel of ``csrc/hamming.cu`` on a CUDA tensor, its plain
version on a CPU tensor) and one MIN all-reduce of (distance, global
index) packed into int64 picks the nearest entry of the whole map.
"""
from __future__ import annotations

import torch.distributed as dist

from ..ops import hamming
from .multihost import check_backend, global_mesh, rank_rows

PACK_SHIFT = 32          # the index takes the low 32 bits of the pack


def make_sharded_matcher(group=None):
    """Returns matcher(qdesc (B, F, 8), map_desc (B, M, 8), map_valid
    (B, M)) -> (nn_global_idx (B, F), nn_dist (B, F)), int64, with the
    map's M entries split over the n ranks of `group` (``global_mesh()``
    without one; M must divide by n;
    every rank is given the whole table, as ``detect_loop_closures``
    holds it, and reads its M/n rows). Ties go to the lowest distance,
    then the lowest global index, as in the single search; a query with
    no valid entry gets (0, 10000). The reference packs the distance
    above 17 index bits and clips the index there; the pack here keeps 32
    index bits, so the two agree for M < 131072 and this one stays exact
    above."""
    group = global_mesh() if group is None else group

    def matcher(qdesc, map_desc, map_valid):
        lo, hi = rank_rows(map_desc.shape[1], group)
        d, i = hamming.hamming_nn(qdesc.contiguous(),
                                  map_desc[:, lo:hi].contiguous(),
                                  map_valid[:, lo:hi].contiguous())
        packed = (d << PACK_SHIFT) + (i + lo)
        check_backend(group, packed)
        dist.all_reduce(packed, op=dist.ReduceOp.MIN, group=group)
        return packed & ((1 << PACK_SHIFT) - 1), packed >> PACK_SHIFT
    return matcher
