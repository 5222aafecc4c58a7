"""Plain torch versions of the grouped-matmul MoE kernel.

Counterparts of ``repro.kernels.moe_gmm.ref``.  ``gmm_ref`` is also what
the CUDA kernel (K4) computes: the wrapper in ``kernel.py`` runs it for CPU
tensors, and the kernel is held against it on the card.  It multiplies
each expert's row tiles with that expert's weights, one product per
expert, instead of gathering a (Tp, D, F) weight per row as the reference
oracle does: at OLMoE's sizes that gather would take 340 GB.
"""
from __future__ import annotations

import torch


def gmm_ref(xs: torch.Tensor, w: torch.Tensor, tile_expert: torch.Tensor,
            tm: int) -> torch.Tensor:
    """Group-aligned grouped matmul: (Tp, F) f32, row i = xs[i] @
    w[tile_expert[i // tm]], in f32 (in f64 for f64 operands).  Expert ids follow the reference's
    (JAX's) indexing rule, as the kernel does: a negative id counts from
    the end, then ids are clamped into [0, E)."""
    tp, E = xs.shape[0], w.shape[0]
    te = tile_expert.long()
    row_expert = torch.where(te < 0, te + E, te).clamp(0, E - 1)
    row_expert = row_expert.repeat_interleave(tm)[:tp]
    dt = torch.promote_types(xs.dtype, torch.float32)   # f64 stays f64
    out = torch.zeros((tp, w.shape[2]), dtype=dt, device=xs.device)
    for e in torch.unique(row_expert).tolist():
        rows = torch.nonzero(row_expert == e).reshape(-1)
        out[rows] = xs[rows].to(dt) @ w[e].to(dt)
    return out


def moe_ffn_ref(x, gate, idx, wg, wu, wd):
    """Dense one-hot oracle in f32 — identical math to the naive
    formulation the LiLAC pass detects (harness 'dense')."""
    E = wg.shape[0]
    onehot = torch.nn.functional.one_hot(idx.long(), E).float()
    combine = torch.einsum("tke,tk->te", onehot, gate.float())
    xf = x.float()
    g = torch.einsum("td,edf->etf", xf, wg.float())
    u = torch.einsum("td,edf->etf", xf, wu.float())
    h = torch.nn.functional.silu(g) * u
    y = torch.einsum("etf,efd->etd", h, wd.float())
    return torch.einsum("te,etd->td", combine, y)
