"""RecurrentGemma-9B (Griffin): RG-LRU recurrent blocks + local attention,
pattern 2 recurrent : 1 local-attention ('RRA'). MQA (kv=1), window 2048.
[arXiv:2402.19427]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    layer_pattern="RRA",
    d_rnn=4096,
    local_window=2048,
    source="arXiv:2402.19427",
)
