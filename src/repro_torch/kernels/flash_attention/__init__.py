from .ops import (FlashAttention, flash_attention,  # noqa: F401
                  flash_attention_bwd, flash_attention_plain)
