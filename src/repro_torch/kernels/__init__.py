"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``ref.py``) and its wrapper (``ops.py``).

Every wrapper counts its kernel's launches in ``ops.launches``; every plain
version counts its calls in ``ref.calls``.
"""
