"""The port's hand-written CUDA kernels (sources in `csrc/`), each with its
plain PyTorch version. A wrapper takes the plain version for CPU tensors and
launches its kernel for CUDA tensors, counting launches in `.launches`."""

from ._lib import build, ptxas_log  # noqa: F401
from .decode_attention import decode_attention, decode_attention_plain
from .flash_attention import flash_attention, flash_attention_plain
from .moe_gmm import moe_gmm_fused, moe_gmm_fused_plain

#: the wrappers, by kernel name
KERNELS = {"flash_attention": flash_attention,
           "decode_attention": decode_attention,
           "moe_gmm_fused": moe_gmm_fused}


def reset_launch_counts() -> None:
    for wrapper in KERNELS.values():
        wrapper.launches = 0


def launch_counts() -> dict:
    return {name: w.launches for name, w in KERNELS.items()}
