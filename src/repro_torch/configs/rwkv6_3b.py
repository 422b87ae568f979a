"""RWKV-6 'Finch' 3B — attention-free SSM with data-dependent decay.
[arXiv:2404.05892]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=0,
    d_ff=8960,
    vocab_size=65536,
    rwkv_head_size=64,
    rope_variant="none",
    source="arXiv:2404.05892",
)
