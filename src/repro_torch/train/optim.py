"""AdamW with f32 master weights, a cosine schedule, global-norm clipping
and bias correction, and the optional int8 block-quantized gradient
compression with error feedback.

Counterpart of ``repro.train.optim``.  Parameters, gradients and the
optimizer state are nested dicts of tensors (any pytree
``torch.utils._pytree`` reads); the functions are plain torch on them and
return new trees.  The compression round trip quantizes each 256-element
block to int8 and keeps the residual for the next step
(arXiv:1712.01887-style); on one device it is the same arithmetic the
reference applies before its data-axis all-reduce.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
from torch.utils import _pytree as pytree

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

@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state, params):
    """Returns (new_params, new_state, metrics)."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    new_err = None
    if cfg.compress_grads:
        pairs = pytree.tree_map(
            lambda g, e: compress_roundtrip(g, e, cfg.compress_block),
            grads, state["err"])
        is_pair = lambda x: isinstance(x, tuple)  # noqa: E731
        grads = pytree.tree_map(lambda pr: pr[0], pairs, is_leaf=is_pair)
        new_err = pytree.tree_map(lambda pr: pr[1], pairs, is_leaf=is_pair)

    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(F32)))
                           for g in pytree.tree_leaves(grads)))
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
    new_params = pytree.tree_map(lambda m, p: m.to(p.dtype), new_master,
                                 params)
    new_state = {"step": step, "mu": new_mu, "nu": new_nu,
                 "master": new_master}
    if new_err is not None:
        new_state["err"] = new_err
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
