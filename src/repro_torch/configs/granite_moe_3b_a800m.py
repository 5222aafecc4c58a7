"""granite-moe-3b-a800m — 40 experts, top-8.
[moe] 32L d_model=1536 24H (GQA kv=8) d_ff=512/expert vocab=49155
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    moe_experts=40,
    moe_topk=8,
    source="[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]",
))
