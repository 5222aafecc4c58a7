"""Shared layers: the MoE expert FFN (naive dense dispatch, and the same
passed through LiLAC).

Counterpart of the MoE part of ``repro.models.layers``: ``moe_spec``,
``moe_router``, ``_moe_naive_2d`` and ``moe_block`` with ``impl="naive"``
or ``"lilac"``.  Parameters are a dict of tensors: ``moe_params`` draws
them from a seeded ``torch.Generator``, ``moe_params_from_numpy`` takes
the JAX package's as numpy arrays.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def moe_spec(d_model: int, d_ff: int, n_experts: int,
             dtype=torch.bfloat16) -> Dict[str, Tuple[Tuple[int, ...],
                                                      torch.dtype]]:
    """name -> (shape, dtype) of the MoE parameters (router in f32)."""
    return {
        "router": ((d_model, n_experts), torch.float32),
        "wg": ((n_experts, d_model, d_ff), dtype),
        "wu": ((n_experts, d_model, d_ff), dtype),
        "wd": ((n_experts, d_ff, d_model), dtype),
    }


def moe_params(spec, generator: torch.Generator, device=None
               ) -> Dict[str, torch.Tensor]:
    """Normal parameters with the reference's scale (std 1/sqrt(shape[0]),
    ``repro.models.spec.init_params``), drawn in f32 on the generator's
    device and cast."""
    device = device or generator.device
    out = {}
    for name, (shape, dtype) in spec.items():
        t = torch.randn(shape, generator=generator, device=device)
        out[name] = (t / np.sqrt(max(shape[0], 1))).to(dtype)
    return out


def moe_params_from_numpy(p: Mapping, device="cpu") -> Dict[str, torch.Tensor]:
    """The JAX package's MoE parameters (anything numpy can read: jax
    arrays of any dtype, bf16 included) as this package's tensors."""
    out = {}
    for name in ("router", "wg", "wu", "wd"):
        a = np.asarray(p[name])
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))
        out[name] = t.to(device)
    return out


def moe_router(p, x: torch.Tensor, topk: int):
    """returns (gate (B,S,K) f32 normalized, idx (B,S,K) int32, aux_loss)."""
    logits = torch.einsum("bsd,de->bse", x.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, topk, dim=-1)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    # load-balancing auxiliary loss (Switch-style)
    E = p["router"].shape[-1]
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(idx[..., 0], E).float().mean(dim=(0, 1))
    aux = E * torch.sum(me * ce)
    return gate, idx.to(torch.int32), aux


def _moe_naive_2d(x, gate, idx, wg, wu, wd):
    """The canonical naive formulation — the form the LiLAC detector's
    moe_ffn matcher targets (see core/detect.py MoeMatcher)."""
    E = wg.shape[0]
    onehot = F.one_hot(idx.long(), E).to(x.dtype)
    combine = torch.einsum("tke,tk->te", onehot, gate.to(x.dtype))
    g = torch.einsum("td,edf->etf", x, wg)
    u = torch.einsum("td,edf->etf", x, wu)
    h = F.silu(g) * u
    y = torch.einsum("etf,efd->etd", h, wd)
    return torch.einsum("te,etd->td", combine, y)


_LILAC_MOE: Dict[str, object] = {}


def _lilac_moe_2d(platform: str):
    """lilac.compile applied to the naive form in trace mode, as the
    reference compiles it, one per platform and cached at module level
    (detection and the rewritten graph are built once per shape
    signature)."""
    if platform not in _LILAC_MOE:
        from repro_torch import lilac
        _LILAC_MOE[platform] = lilac.compile(_moe_naive_2d, platform=platform)
    return _LILAC_MOE[platform]


def moe_block(p, x: torch.Tensor, *, topk: int, impl: str = "naive"):
    """x: (B, S, D).  Groups are sequences: the expert FFN runs once per
    sequence, ``impl="lilac"`` through one compiled function (one trace for
    all sequences of a shape).  Returns (out, aux_loss)."""
    gate, idx, aux = moe_router(p, x, topk)
    wg, wu, wd = p["wg"], p["wu"], p["wd"]
    if impl == "naive":
        fn = _moe_naive_2d
    elif impl == "lilac":
        fn = _lilac_moe_2d(x.device.type)
    else:
        raise ValueError(f"impl must be 'naive' or 'lilac', got {impl!r}")
    out = torch.stack([fn(x[b], gate[b], idx[b], wg, wu, wd)
                       for b in range(x.shape[0])])
    return out, aux
