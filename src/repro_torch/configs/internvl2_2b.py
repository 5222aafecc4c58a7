"""internvl2-2b — InternViT frontend (STUB) + InternLM2 backbone.
[vlm] 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553
[arXiv:2404.16821; hf]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92553,
    frontend="stub",       # precomputed patch embeddings via input_specs()
    source="[arXiv:2404.16821; hf]",
))
