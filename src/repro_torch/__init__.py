"""PyTorch/CUDA port of the ``repro`` model stack for NVIDIA Hopper.

The JAX package ``repro`` is the reference.  This package imports nothing
of it and nothing of JAX; its layout mirrors ``src/repro/`` file for file.
"""
