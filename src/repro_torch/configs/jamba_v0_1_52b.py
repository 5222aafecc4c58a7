"""jamba-v0.1-52b — Mamba+attention 1:7 interleave, MoE 16e top-2.
[hybrid] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536
[arXiv:2403.19887; hf]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    moe_experts=16,
    moe_topk=2,
    attn_layer_period=8,   # 1 attention : 7 mamba per 8-layer period
    attn_layer_offset=4,
    moe_layer_period=2,    # MoE on odd layer indices (16 of 32 layers)
    source="[arXiv:2403.19887; hf]",
))
