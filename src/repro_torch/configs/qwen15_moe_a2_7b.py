"""Qwen1.5-MoE A2.7B — 60 routed top-4 + 4 shared (paper Table 1)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen15-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    moe_d_ff=1408,
    vocab_size=151936,
    num_experts=60,
    experts_per_token=4,
    num_shared_experts=4,
    source="qwenlm.github.io/blog/qwen-moe (paper Table 1)",
)
