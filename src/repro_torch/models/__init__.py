"""Model code of the port: config, layers, attention, MoE, transformer."""
