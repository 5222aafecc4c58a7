"""repro_torch — the PyTorch/CUDA port of the LiLAC reproduction.

A package beside ``repro`` (the JAX reference) with the same module
layout; it imports torch and never JAX or ``repro``.  Entry point:
``repro_torch.lilac.compile``.
"""
