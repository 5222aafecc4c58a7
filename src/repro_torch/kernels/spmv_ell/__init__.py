"""ELL SpMV: the resident (K1) and column-windowed (K2) CUDA kernels."""
