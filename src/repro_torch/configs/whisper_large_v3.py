"""Whisper large-v3, an encoder-decoder audio model. The mel-spectrogram,
conv frontend and encoder are a stub: callers pass precomputed 1500-frame
encoder states (`enc_out=`); this config is the decoder backbone.
[arXiv:2212.04356]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    is_encoder_decoder=True,
    encoder_len=1500,
    rope_variant="none",   # sinusoid positions (learned in the original)
    norm="layernorm",
    activation="gelu",
    source="arXiv:2212.04356",
)
