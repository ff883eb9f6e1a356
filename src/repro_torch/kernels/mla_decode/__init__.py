"""Absorbed MLA decode: Hopper kernel (csrc/mla_decode.cu) + plain version."""
