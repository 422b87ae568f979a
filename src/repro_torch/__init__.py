"""PyTorch and CUDA port of the Cascade MoE speculative-decoding system.

Importing the package needs neither a card nor `nvcc`: the CUDA kernels
under `csrc/` are compiled on their first launch (`kernels.build`)."""
