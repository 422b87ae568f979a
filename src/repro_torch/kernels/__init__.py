"""The port's hand-written CUDA kernels (sources in `csrc/`), each with its
plain PyTorch version. A wrapper takes the plain version for CPU tensors and
launches its kernel for CUDA tensors, counting launches in `.launches`;
`flash_attention`, `decode_attention`, `moe_gmm_fused`,
`moe_gmm_fused_quant` and `moe_gmm`, whose C launchers pick a route from
dtype and shape, also count them by route in `.launches_by_route`. The
two recurrences' backwards (`rwkv_scan_bwd`, `linear_scan_bwd`) are
kernels of their forwards' sources, and `RwkvScan`, `LinearScan`,
`FlashAttention` and `MoeGmm` the training path's autograd functions."""

from ._lib import build, library_path, ptxas_log  # noqa: F401
from .decode_attention import decode_attention, decode_attention_plain
from .flash_attention import (FlashAttention, flash_attention,
                              flash_attention_bwd, flash_attention_plain)
from .linear_scan import (LinearScan, linear_scan, linear_scan_bwd,
                          linear_scan_bwd_plain, linear_scan_plain)
from .moe_gmm import (MoeGmm, moe_gmm, moe_gmm_fused, moe_gmm_fused_plain,
                      moe_gmm_fused_quant, moe_gmm_fused_quant_plain,
                      moe_gmm_plain)
from .rwkv_scan import (RwkvScan, rwkv_scan, rwkv_scan_bwd,
                        rwkv_scan_bwd_plain, rwkv_scan_plain)

#: the wrappers, by kernel name
KERNELS = {"flash_attention": flash_attention,
           "decode_attention": decode_attention,
           "moe_gmm_fused": moe_gmm_fused,
           "moe_gmm_fused_quant": moe_gmm_fused_quant,
           "moe_gmm": moe_gmm,
           "rwkv_scan": rwkv_scan,
           "linear_scan": linear_scan,
           "rwkv_scan_bwd": rwkv_scan_bwd,
           "linear_scan_bwd": linear_scan_bwd}


def reset_launch_counts() -> None:
    for wrapper in KERNELS.values():
        wrapper.launches = 0
        for route in getattr(wrapper, "launches_by_route", ()):
            wrapper.launches_by_route[route] = 0


def launch_counts() -> dict:
    return {name: w.launches for name, w in KERNELS.items()}


def route_counts() -> dict:
    """Launches by route of the kernels with more than one route."""
    return {name: dict(w.launches_by_route) for name, w in KERNELS.items()
            if hasattr(w, "launches_by_route")}
