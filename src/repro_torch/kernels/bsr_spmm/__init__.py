"""BCSR SpMM: the hand-written CUDA kernel K3, its plain version and its
HARNESS blocks."""
