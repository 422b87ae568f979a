"""DeepSeek-V2 236B: MLA (kv_lora=512, q_lora=1536), 160 routed experts
top-6 + 2 shared. [arXiv:2405.04434]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    head_dim=192,            # qk_nope + qk_rope
    d_ff=1536,
    moe_d_ff=1536,
    vocab_size=102400,
    num_experts=160,
    experts_per_token=6,
    num_shared_experts=2,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    source="arXiv:2405.04434",
)
