"""RWKV-6 WKV scan: Hopper kernel (csrc/rwkv6_scan.cu) + plain version."""
