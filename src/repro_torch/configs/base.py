"""The config dataclasses, the LM shapes and the ``--arch`` registry.

Counterpart of ``repro.configs.base``, with torch dtypes.  ``ArchConfig``
keeps the fields that describe a published architecture and those that
the models of ``repro_torch.models`` read: the head width (``head_dim``,
d_model / n_heads unless set), causal or bidirectional attention
(``causal``), token embeddings or a stub frontend's precomputed ones
(``frontend="stub"``), Mamba's state width (``d_state``) and the hybrid
period (``attn_layer_period``, ``attn_layer_offset``,
``moe_layer_period``).  RoPE base 1e4 and the grouped MoE's capacity
factor 2.0 are what every registered config uses.  ``cache_dtype`` is
the KV cache's and ``moe_decode_impl`` the MoE formulation of the
one-token decode step (``"naive_flat"`` is the dense dispatch the
detector matches, which the serving tier compiles).  ``ShapeConfig``,
``SHAPES`` and ``shape_skips`` are the reference's four LM shapes and
which architecture skips which.  The distribution settings are the
reference's: ``spmd_constraints`` turns on the mesh path of the models
(the storage -> compute weight gathers, expert parallelism, tensor and
sequence parallelism; ``launch.collectives``), ``mesh_axis_sizes`` names
the mesh's axes and sizes, ``seq_parallel`` shards the residual stream
over the model axis between blocks, ``decode_cache_seq_shard`` shards an
MQA decode cache over the model axis on its sequence dim, and
``moe_combine_bf16`` reduces the expert-parallel partial sums in the
activations' dtype instead of f32.  ``capacity_factor`` is the grouped
dispatch's slots an expert, over the mean load (2.0 in every registered
config, as in the reference).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

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
    head_dim: Optional[int] = None
    moe_experts: int = 0
    moe_topk: int = 0
    norm: str = "rmsnorm"         # rmsnorm | layernorm_nonparam
    causal: bool = True
    frontend: str = "none"        # none | stub  (stub: precomputed embeds)
    d_state: int = 16             # mamba state width
    attn_layer_period: int = 0    # jamba: 8
    attn_layer_offset: int = 4
    moe_layer_period: int = 0     # jamba: 2
    moe_impl: str = "grouped"     # naive | lilac | grouped
    # MoE formulation on the one-token decode path: "grouped_flat" is the
    # capacity-bucket dispatch over the whole batch, "naive_flat" the
    # canonical dense-dispatch form, so that a lilac-compiled decode step
    # exposes the MoE to the detector (the serving tier uses it)
    moe_decode_impl: str = "grouped_flat"
    capacity_factor: float = 2.0
    kv_chunk: int = 1024
    remat: bool = True
    param_dtype: Any = torch.bfloat16
    cache_dtype: Any = torch.bfloat16
    source: str = ""              # provenance note ([arXiv/hf; tier])
    # distribution: with spmd_constraints the models run their mesh path
    # (launch.collectives' current mesh); mesh_axis_sizes is
    # (("data", 16), ("model", 16), ...) and decides divisibility
    spmd_constraints: bool = False
    mesh_axis_sizes: tuple = ()
    # gradient accumulation: activation memory scales 1/microbatches
    microbatches: int = 1
    # the residual stream sharded over the model axis on its sequence dim
    # between blocks (off for the ssm and hybrid families)
    seq_parallel: bool = True
    # decode: an MQA cache (kv heads unshardable) sharded over the model
    # axis on its sequence dim
    decode_cache_seq_shard: bool = False
    # the expert-parallel combine reduced in the activations' dtype
    moe_combine_bf16: bool = False

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


# The four LM shapes assigned to every architecture.
SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


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


def shape_skips(cfg: ArchConfig, shape: ShapeConfig) -> Optional[str]:
    """A skip reason, or None where the architecture runs the shape."""
    subquadratic = cfg.family in ("ssm", "hybrid")
    if shape.name == "long_500k" and not subquadratic:
        return "full-attention arch: 500k decode needs sub-quadratic mixer"
    if shape.kind == "decode" and not cfg.causal:
        return "encoder-only arch has no autoregressive decode step"
    return None


def smoke_config(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests (the reference's
    reduction): two layers, or two periods of a hybrid stack."""
    period = cfg.attn_layer_period or 1
    return cfg.replace(
        n_layers=2 * period if period > 1 else 2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        d_ff=128 if not cfg.moe_experts else 32,
        vocab=256,
        head_dim=16 if cfg.head_dim else None,
        moe_experts=min(cfg.moe_experts, 8) if cfg.moe_experts else 0,
        moe_topk=min(cfg.moe_topk, 2) if cfg.moe_topk else 0,
        kv_chunk=32,
        remat=False,
        param_dtype=torch.float32,
        cache_dtype=torch.float32,
    )
