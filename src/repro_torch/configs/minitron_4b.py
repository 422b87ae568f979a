"""Minitron-4B — width/depth-pruned Nemotron. [arXiv:2407.14679]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    activation="gelu",  # squared-relu in the original; gelu stand-in
    source="arXiv:2407.14679",
)
