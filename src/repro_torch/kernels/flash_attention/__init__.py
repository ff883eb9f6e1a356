"""Flash-attention forward: Hopper kernel (csrc/flash_attention.cu) + plain version."""
