"""OLMoE 1B/7B — 64 experts top-8 (paper Table 1)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,
    moe_d_ff=1024,
    vocab_size=50304,
    num_experts=64,
    experts_per_token=8,
    source="arXiv:2409.02060 (paper Table 1)",
)
