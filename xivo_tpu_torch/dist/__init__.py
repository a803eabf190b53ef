"""Distribution on ``torch.distributed`` (port of ``xivo_tpu/dist``): the
landmark-sharded bundle adjustment, the sharded loop-closure retrieval,
segment-parallel trajectories and multi-process groups."""
from .ba import make_distributed_solver, shard_problem
from .retrieval import make_sharded_matcher

__all__ = ["make_distributed_solver", "shard_problem",
           "make_sharded_matcher"]
