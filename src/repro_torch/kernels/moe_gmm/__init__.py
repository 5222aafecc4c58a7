"""Grouped matmul for the MoE expert FFN: the hand-written CUDA kernel K4,
its plain version and its HARNESS block."""
