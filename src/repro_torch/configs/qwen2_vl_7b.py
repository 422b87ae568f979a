"""Qwen2-VL-7B language backbone: M-RoPE (t/h/w sections), dynamic
resolution. The ViT vision tower is a stub: callers pass precomputed patch
embeddings (`embeds=`) and 3-D position ids (`rope_pos=`).
[arXiv:2409.12191]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    rope_variant="mrope",
    mrope_sections=(16, 24, 24),
    vision_stub=True,
    source="arXiv:2409.12191",
)
