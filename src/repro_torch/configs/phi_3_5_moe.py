"""Phi-3.5-MoE 16x3.8B (paper Table 1)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3.5-moe",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    moe_d_ff=6400,
    vocab_size=32064,
    num_experts=16,
    experts_per_token=2,
    source="arXiv:2404.14219 (paper Table 1)",
)
