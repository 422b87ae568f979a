from .ops import (MoeGmm, moe_gmm, moe_gmm_fused,  # noqa: F401
                  moe_gmm_fused_plain, moe_gmm_fused_quant,
                  moe_gmm_fused_quant_plain, moe_gmm_plain)
