"""Mixtral 8x7B — the paper's primary evaluation MoE (Table 1)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    moe_d_ff=14336,
    vocab_size=32000,
    num_experts=8,
    experts_per_token=2,
    source="arXiv:2401.04088 (paper Table 1)",
)
