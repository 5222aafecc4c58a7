"""The config dataclass and the ``--arch`` registry.

Counterpart of ``repro.configs.base``, with torch dtypes.  ``ArchConfig``
keeps the fields that describe a published architecture and those that
the dense and MoE transformers and RWKV-6 of ``repro_torch.models`` read:
causal attention over token embeddings, head width d_model / n_heads,
RoPE base 1e4 and the grouped MoE's capacity factor 2.0 are what every
registered config uses.  ``cache_dtype`` is the KV cache's and
``moe_decode_impl`` the MoE formulation of the one-token decode step
(``"naive_flat"`` is the dense dispatch the detector matches, which the
serving tier compiles).  The reference's settings for other heads,
frontends, Mamba and sharding come with the configs and slices that use
them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

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
    norm: str = "rmsnorm"         # rmsnorm | layernorm_nonparam
    moe_impl: str = "grouped"     # naive | lilac | grouped
    # MoE formulation on the one-token decode path: "grouped_flat" is the
    # capacity-bucket dispatch over the whole batch, "naive_flat" the
    # canonical dense-dispatch form, so that a lilac-compiled decode step
    # exposes the MoE to the detector (the serving tier uses it)
    moe_decode_impl: str = "grouped_flat"
    kv_chunk: int = 1024
    remat: bool = True
    param_dtype: Any = torch.bfloat16
    cache_dtype: Any = torch.bfloat16
    source: str = ""              # provenance note ([arXiv/hf; tier])
    # gradient accumulation: activation memory scales 1/microbatches
    microbatches: int = 1

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  (registers every config)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_archs() -> Dict[str, ArchConfig]:
    import repro_torch.configs  # noqa: F401
    return dict(_REGISTRY)


def smoke_config(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests (the reference's
    reduction, for the families this package runs)."""
    return cfg.replace(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        d_ff=128 if not cfg.moe_experts else 32,
        vocab=256,
        moe_experts=min(cfg.moe_experts, 8) if cfg.moe_experts else 0,
        moe_topk=min(cfg.moe_topk, 2) if cfg.moe_topk else 0,
        kv_chunk=32,
        remat=False,
        param_dtype=torch.float32,
        cache_dtype=torch.float32,
    )
