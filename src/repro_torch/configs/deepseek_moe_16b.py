"""DeepSeekMoE 16.4B — 64 routed top-6 + 2 shared (paper Table 1)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    moe_d_ff=1408,
    vocab_size=102400,
    num_experts=64,
    experts_per_token=6,
    num_shared_experts=2,
    source="arXiv:2401.06066 (paper Table 1)",
)
