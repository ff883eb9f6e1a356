"""Flash-decode: Hopper kernel (csrc/decode_attention.cu) + plain version."""
