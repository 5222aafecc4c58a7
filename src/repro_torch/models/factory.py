"""Model factory: ArchConfig -> Model (spec, parameters, the loss,
prefill, decode, the batched cache's slot hooks and the inputs of each
LM shape).

Counterpart of ``repro.models.factory``; ``params_from_numpy`` carries the
JAX package's parameter tree across, so that both packages compute the
same model.  The reference's cache hooks return new caches (XLA copies or
donates); here ``cache_set_slot`` and ``cache_move_slot`` are row copies
into the cache they are given, which they return, and ``cache_resize``
returns new contiguous buffers.  ``input_specs`` returns tensors on the
``meta`` device, the counterpart of ``jax.ShapeDtypeStruct``: a shape and
a dtype, with no storage.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import mamba as M
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
        """batch: tokens + labels -> scalar loss.  On the mesh
        (``cfg.spmd_constraints``) params and batch are the rank's shards
        and the result is the rank's share: the shares sum to the loss."""
        x, aux, _ = T.forward(self.cfg, params, batch)
        loss = T.lm_loss(self.cfg, params, x, batch["labels"])
        if self.cfg.spmd_constraints:     # aux: the same on every rank
            return loss + 0.01 * aux / T._n_ranks(self.cfg)
        return loss + 0.01 * aux

    # -- prefill and decode ---------------------------------------------------

    def prefill(self, params, batch: Dict[str, Any]):
        """(logits of the last position (B, V) f32, the caches stacked over
        the periods)."""
        x, _, caches = T.forward(self.cfg, params, batch, collect_cache=True)
        seq = batch["embeds" if "embeds" in batch else "tokens"].shape[1]
        return T.lm_logits_last(self.cfg, params, x, seq), caches

    def decode(self, params, cache, tokens, pos, cache_specs=None):
        """One decode step; on the mesh ``cache_specs`` is the cache's
        partition-spec tree."""
        return T.decode_step(self.cfg, params, cache, tokens, pos,
                             cache_specs)

    def init_cache(self, B: int, max_seq: int, device=None):
        return T.init_cache(self.cfg, B, max_seq, device)

    def cache_from_prefill(self, caches, prefill_len: int, max_seq: int):
        """The prefill's stacked, length-L caches as the per-layer decode
        cache, k/v zero-padded to ``max_seq`` in ``cfg.cache_dtype``; the
        recurrent leaves as the prefill left them (a Mamba conv tail in
        the activations' dtype, as in the reference: ``cache_set_slot``
        casts it into the cache's f32)."""
        out = {}
        for j in range(T.n_periods(self.cfg)):
            period = {}
            for bkey, entries in caches.items():
                ce = {}
                for name, leaf in entries.items():
                    a = leaf[j]
                    if name in ("k", "v"):
                        a = F.pad(a, (0, 0, 0, 0, 0, max_seq - a.shape[1])
                                  ).to(self.cfg.cache_dtype)
                    ce[name] = a
                period[bkey] = ce
            out[f"p{j}"] = period
        return out

    # -- the batched cache's slots (serving) -----------------------------------

    def cache_set_slot(self, cache, slot: int, row_cache):
        """Copy a one-request cache (every leaf batch 1, the same capacity)
        into row ``slot`` of ``cache``; returns ``cache``."""
        S.tree_map(lambda full, one: full[slot].copy_(one[0]), cache,
                   row_cache)
        return cache

    def cache_move_slot(self, cache, src: int, dst: int):
        """Copy row ``src`` over row ``dst`` (slot compaction after an
        eviction; the stale ``src`` row stays behind, never read once the
        scheduler shrinks the active prefix); returns ``cache``."""
        S.tree_map(lambda a: a[dst].copy_(a[src]), cache)
        return cache

    def cache_resize(self, cache, B: Optional[int] = None,
                     max_seq: Optional[int] = None):
        """Re-bucket a cache into new contiguous buffers: the batch axis
        (axis 0 of every leaf) and the capacity axis of the k/v leaves
        (axis 1, keyed by the leaf's name: Mamba's 3-D conv tail has the
        kernel width there) padded with zeros or cut (the engine cuts only
        what no active request uses)."""
        def fix(a, name):
            if B is not None and a.shape[0] != B:
                a = (F.pad(a, (0, 0) * (a.dim() - 1) + (0, B - a.shape[0]))
                     if B > a.shape[0] else a[:B])
            if max_seq is not None and name in ("k", "v") \
                    and a.shape[1] != max_seq:
                a = (F.pad(a, (0, 0) * (a.dim() - 2)
                           + (0, max_seq - a.shape[1]))
                     if max_seq > a.shape[1] else a[:, :max_seq])
            return (a.clone(memory_format=torch.contiguous_format)
                    if a._base is not None else a)

        def walk(tree):
            return {k: walk(v) if isinstance(v, dict) else fix(v, k)
                    for k, v in tree.items()}

        return walk(cache)

    def prefill_cache_specs(self, shape: ShapeConfig) -> Dict[str, Any]:
        """``meta`` tensors of what ``prefill`` returns as caches at
        ``shape`` (each block's entries stacked over the periods), from
        the shapes alone: the counterpart of ``jax.eval_shape`` of the
        prefill, which the dry-run's sharding trees read."""
        cfg = self.cfg
        P, B, Sq = T.n_periods(cfg), shape.global_batch, shape.seq_len
        hd, di, D = cfg.resolved_head_dim, 2 * cfg.d_model, cfg.d_model
        # the activations' dtype: the embedding table's, or a stub
        # frontend's embeddings cast to param_dtype
        act = (self.spec["embed"].dtype if cfg.frontend == "none"
               else cfg.param_dtype)

        def meta(shape, dtype):
            return torch.empty((P,) + shape, dtype=dtype, device="meta")

        out = {}
        for i, (mx, ff) in enumerate(T.arch_pattern(cfg)):
            if mx == "attn":
                kv = (B, Sq, cfg.n_kv_heads, hd)
                ce = {"k": meta(kv, act), "v": meta(kv, act)}
            elif mx == "mamba":
                ce = {"ssm": meta((B, di, cfg.d_state), torch.float32),
                      "conv": meta((B, M.CONV_K - 1, di), act)}
            else:
                ce = {"s": meta((B, cfg.n_heads, D // cfg.n_heads,
                                 D // cfg.n_heads), torch.float32),
                      "last_tm": meta((B, D), act)}
            if ff == "channelmix":
                ce["last_cm"] = meta((B, D), act)
            out[f"b{i}"] = ce
        return out

    # -- the inputs of an LM shape ---------------------------------------------

    def input_specs(self, shape: ShapeConfig) -> Dict[str, Any]:
        """``meta`` tensors standing in for every model input (no
        allocation).

        train:   {"tokens"/"embeds", "labels"}
        prefill: {"tokens"/"embeds"}
        decode:  {"tokens", "pos", "cache"}  (a cache of seq_len)
        """
        cfg = self.cfg
        B, Sq = shape.global_batch, shape.seq_len

        def meta(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        if shape.kind in ("train", "prefill"):
            inp = ({"embeds": meta((B, Sq, cfg.d_model), cfg.param_dtype)}
                   if cfg.frontend == "stub"
                   else {"tokens": meta((B, Sq), torch.int32)})
            if shape.kind == "train":
                inp["labels"] = meta((B, Sq), torch.int32)
            return inp
        if shape.kind == "decode":
            return {"tokens": meta((B, 1), torch.int32),
                    "pos": meta((), torch.int32),
                    "cache": self.init_cache(B, Sq, device="meta")}
        raise ValueError(shape.kind)


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
