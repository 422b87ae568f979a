"""Kimi K2 — trillion-parameter MoE, per the assigned paper-table config.
[arXiv:2501.kimi2]. Assigned as GQA (kv=8); 384 routed experts, top-8,
sigmoid (DeepSeek-V3-style) router scores."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=2048,
    moe_d_ff=2048,
    vocab_size=163840,
    num_experts=384,
    experts_per_token=8,
    num_shared_experts=1,
    router_score="sigmoid",
    rope_theta=50000.0,
    optimizer="adafactor",  # Adam m,v for ~1T params cannot fit the mesh
    source="arXiv:2501.kimi2 (paper-table)",
)
