"""Hand-written CUDA kernels for Hopper, one package per kernel family,
each with its plain torch version and its HARNESS block."""
