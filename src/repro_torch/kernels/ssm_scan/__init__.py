"""Mamba selective scan: Hopper kernel (csrc/ssm_scan.cu) + plain version."""
