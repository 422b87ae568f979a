from .ops import (moe_gmm_fused, moe_gmm_fused_plain,  # noqa: F401
                  moe_gmm_fused_quant, moe_gmm_fused_quant_plain)
