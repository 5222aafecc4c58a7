"""Model factory: ArchConfig -> Model (spec, parameters, the loss).

Counterpart of the training part of ``repro.models.factory``;
``params_from_numpy`` carries the JAX package's parameter tree across, so
that both packages compute the same model (prefill, decode and the cache
helpers come with serving).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import spec as S
from repro_torch.models import transformer as T


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    spec: Dict[str, Any]

    def init(self, generator: torch.Generator, device=None):
        return S.init_params(self.spec, generator, device)

    def param_count(self) -> int:
        return S.count_params(self.spec)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k of the experts)."""
        cfg = self.cfg
        total = self.param_count()
        if not cfg.moe_experts:
            return total
        expert = sum(int(np.prod(s.shape)) for path, s in S.leaves(self.spec)
                     if "moe" in path and "router" not in path)
        return int(total - expert + expert * cfg.moe_topk // cfg.moe_experts)

    def loss_fn(self, params, batch: Dict[str, Any]):
        """batch: tokens + labels -> scalar loss."""
        x, aux = T.forward(self.cfg, params, batch)
        return T.lm_loss(self.cfg, params, x, batch["labels"]) + 0.01 * aux


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg=cfg, spec=T.model_spec(cfg))


def to_tensor(a, device="cpu") -> torch.Tensor:
    """One array of the JAX package (anything numpy reads, bf16 included)
    as a tensor of the same dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(cfg: ArchConfig, params: Mapping, device="cpu"):
    """The JAX model's whole parameter tree (stacked ``blocks``,
    ``embed``, ``unembed``, norms, ``moe``) as this package's, leaf for
    leaf, checked against ``model_spec(cfg)``'s shapes."""
    spec = T.model_spec(cfg)

    def take(s, a):
        t = to_tensor(a, device)
        if tuple(t.shape) != tuple(s.shape):
            raise ValueError(f"shape {tuple(t.shape)} where the spec has "
                             f"{s.shape}")
        return t

    return S.tree_map(take, spec, _as_dict(params, spec))


def _as_dict(tree, like):
    """``tree`` (nested mappings) with the structure of ``like``."""
    if isinstance(like, dict):
        return {k: _as_dict(tree[k], v) for k, v in like.items()}
    return tree
