"""The config dataclass.

Counterpart of ``repro.configs.base``'s ``ArchConfig``, with torch dtypes.
It keeps the fields that describe a published architecture and that the
port's models read; the reference's settings for attention, SSMs,
remat, caches and sharding come with the slices that use them.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense|moe|ssm|hybrid|encoder|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    moe_experts: int = 0
    moe_topk: int = 0
    param_dtype: Any = torch.bfloat16
    source: str = ""              # provenance note ([arXiv/hf; tier])

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)
