"""olmoe-1b-7b — 64 experts, top-8. The primary LiLAC MoE target.
[moe] 16L d_model=2048 16H (GQA kv=16) d_ff=1024/expert vocab=50304
[arXiv:2409.02060; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    moe_experts=64,
    moe_topk=8,
    source="[arXiv:2409.02060; hf]",
)
