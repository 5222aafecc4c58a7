"""olmo-1b — non-parametric LayerNorm dense.
[dense] 16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304
[arXiv:2402.00838; hf]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=50304,
    norm="layernorm_nonparam",
    source="[arXiv:2402.00838; hf]",
))
