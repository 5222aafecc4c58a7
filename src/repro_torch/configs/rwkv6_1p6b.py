"""rwkv6-1.6b — Finch, attention-free, data-dependent decay.
[ssm] 24L d_model=2048 d_ff=7168 vocab=65536 [arXiv:2404.05892; unverified]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,            # rwkv6 head_dim 64
    n_kv_heads=32,
    d_ff=7168,
    vocab=65536,
    source="[arXiv:2404.05892; unverified]",
))
