"""Expert parallelism over torch.distributed: each rank holds a slice of
the routed experts and exchanges token inputs with one all-to-all each
way (`make_expert_parallel_moe`), forward and backward; a whole model's
params are cut per rank by `shard_params` and put back together by
`gather_params`."""

from .expert_parallel import (gather_params, make_expert_parallel_moe,
                              param_cuts, reduce_gradients, shard_moe_params,
                              shard_params)

__all__ = ["gather_params", "make_expert_parallel_moe", "param_cuts",
           "reduce_gradients", "shard_moe_params", "shard_params"]
