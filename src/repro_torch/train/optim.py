"""AdamW with f32 master weights, a cosine schedule, global-norm clipping
and bias correction, and the optional int8 block-quantized gradient
compression with error feedback.

Counterpart of ``repro.train.optim``.  Parameters, gradients and the
optimizer state are nested dicts of tensors (any pytree
``torch.utils._pytree`` reads); the functions are plain torch on them and
return new trees.  The compression round trip quantizes each 256-element
block to int8 and keeps the residual for the next step
(arXiv:1712.01887-style), on the reduced gradient, as the reference
quantizes its global gradient.

On a mesh (``mesh_specs``: each leaf's storage partition spec, under
``launch.collectives``' current mesh) the parameters, gradients and
optimizer state are the rank's shards at the parameters' placements:
the update is elementwise on them; the global norm sums each leaf's
squares once over the mesh; and the compression round trip quantizes the
whole reduced gradient (gathered, the same 256-element blocks as on one
device) and keeps the rank's shard of the result and of the residual.
Its payload on the wire is still the f32 gradient: an int8 all-reduce is
not built.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.launch import collectives as C

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    compress_grads: bool = False
    compress_block: int = 256


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to 10 % of ``lr`` (f32)."""
    step = step.to(F32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def adamw_init(cfg: AdamWConfig, params) -> Dict[str, Any]:
    def zeros(p):
        return torch.zeros(p.shape, dtype=F32, device=p.device)

    state = {
        "step": torch.zeros((), dtype=torch.int32,
                            device=pytree.tree_leaves(params)[0].device),
        "mu": pytree.tree_map(zeros, params),
        "nu": pytree.tree_map(zeros, params),
        "master": pytree.tree_map(
            lambda p: p.detach().to(F32, copy=True), params),
    }
    if cfg.compress_grads:
        state["err"] = pytree.tree_map(zeros, params)
    return state


# -- gradient compression -----------------------------------------------------

def _quantize_block_int8(g: torch.Tensor, block: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = g.reshape(-1)
    pad = (-flat.shape[0]) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(blocks / torch.clamp_min(scale, 1e-12)),
                    -127, 127).to(torch.int8)
    return q, scale


def _dequantize_block_int8(q, scale, shape):
    deq = (q.to(F32) * scale).reshape(-1)
    return deq[:math.prod(shape)].reshape(shape)


def compress_roundtrip(g: torch.Tensor, err: torch.Tensor, block: int):
    """Quantize(g + err) -> int8; return (dequantized, new_err)."""
    target = g.to(F32) + err
    q, scale = _quantize_block_int8(target, block)
    deq = _dequantize_block_int8(q, scale, tuple(g.shape))
    return deq, target - deq


# -- update --------------------------------------------------------------------

def _compress_on_mesh(g, err, pspec, block: int):
    """``compress_roundtrip`` of the whole gradient, on the rank's shards."""
    full = tuple(None for _ in pspec)
    deq, new_err = compress_roundtrip(C.reshard(g, pspec, full),
                                      C.reshard(err, pspec, full), block)
    return C.local_of(deq, pspec), C.local_of(new_err, pspec)


def _norm_sq(grads, mesh_specs) -> torch.Tensor:
    """The gradient's squared global norm; on a mesh each leaf's local
    sum over its replication count, summed over every mesh axis."""
    if mesh_specs is None:
        return sum(torch.sum(torch.square(g.to(F32)))
                   for g in pytree.tree_leaves(grads))
    from repro_torch.models.spec import pspec_axes
    names = C.current_mesh().mesh_dim_names

    def leaf(g, ps):
        used = {a for e in ps for a in pspec_axes(e)}
        reps = C.axis_size(tuple(a for a in names if a not in used))
        return torch.sum(torch.square(g.to(F32))) / reps
    return C.psum(sum(pytree.tree_leaves(
        pytree.tree_map(leaf, grads, mesh_specs))), tuple(names))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state, params, mesh_specs=None):
    """Returns (new_params, new_state, metrics).  ``mesh_specs``: the
    leaves' storage partition specs on the current mesh (the mesh
    path)."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    new_err = None
    if cfg.compress_grads:
        if mesh_specs is None:
            pairs = pytree.tree_map(
                lambda g, e: compress_roundtrip(g, e, cfg.compress_block),
                grads, state["err"])
        else:
            pairs = pytree.tree_map(
                lambda g, e, ps: _compress_on_mesh(g, e, ps,
                                                   cfg.compress_block),
                grads, state["err"], mesh_specs)
        is_pair = lambda x: isinstance(x, tuple)  # noqa: E731
        grads = pytree.tree_map(lambda pr: pr[0], pairs, is_leaf=is_pair)
        new_err = pytree.tree_map(lambda pr: pr[1], pairs, is_leaf=is_pair)

    gnorm = torch.sqrt(_norm_sq(grads, mesh_specs))
    scale = torch.clamp(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                        max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(F32)
    bc2 = 1 - b2 ** step.to(F32)

    def upd(g, mu, nu, master):
        g = g.to(F32) * scale
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * g * g
        mhat = mu / bc1
        nhat = nu / bc2
        master = master - lr * (mhat / (torch.sqrt(nhat) + cfg.eps)
                                + cfg.weight_decay * master)
        return mu, nu, master

    triples = pytree.tree_map(upd, grads, state["mu"], state["nu"],
                              state["master"])
    is_triple = lambda x: isinstance(x, tuple)  # noqa: E731
    new_mu = pytree.tree_map(lambda t: t[0], triples, is_leaf=is_triple)
    new_nu = pytree.tree_map(lambda t: t[1], triples, is_leaf=is_triple)
    new_master = pytree.tree_map(lambda t: t[2], triples, is_leaf=is_triple)
    # a copy also at f32, so that no parameter aliases its master weight (a
    # compiled step would otherwise see its inputs alias from step 2 on)
    new_params = pytree.tree_map(lambda m, p: m.to(p.dtype, copy=True),
                                 new_master, params)
    new_state = {"step": step, "mu": new_mu, "nu": new_nu,
                 "master": new_master}
    if new_err is not None:
        new_state["err"] = new_err
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
