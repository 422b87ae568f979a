"""Expert parallelism over torch.distributed: each rank holds a slice of
the routed experts and exchanges token inputs with one all-to-all each
way (`make_expert_parallel_moe`)."""

from .expert_parallel import make_expert_parallel_moe, shard_moe_params

__all__ = ["make_expert_parallel_moe", "shard_moe_params"]
