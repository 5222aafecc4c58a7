"""Routing, sort, group alignment and the three grouped matmuls of the MoE
expert FFN.

Counterpart of ``repro.kernels.moe_gmm.ops``.  ``moe_ffn`` is exact with
respect to the naive dense-dispatch oracle (no capacity drops) while
doing ~E/K times less matmul work.  The gated combine stays plain torch
(``index_add_``), as the reference leaves it to XLA.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels.moe_gmm.kernel import gmm_cuda
from repro_torch.kernels.moe_gmm.ref import moe_ffn_ref


def _route(idx: torch.Tensor, T: int, K: int, E: int, tm: int
           ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Sort (token, k) pairs by expert and compute group-aligned row slots.

    Returns (dest, tile_expert, Tp):
      dest:        (T*K,) destination row of each flat pair in the aligned
                   buffer (rows grouped by expert, groups padded to tm)
      tile_expert: (Tp//tm,) int32 expert id of every row tile; the tail
                   tiles past the last group take E-1
    Tp is the static worst case: the pairs rounded up to tiles plus one
    partial tile per other expert.  A pair's rank within its expert comes
    from one stable sort, not from the reference's (T*K, E) one-hot; the
    values are the same.
    """
    TK = T * K
    Tp = int(math.ceil(TK / tm) * tm + (E - 1) * tm)
    flat_e = idx.reshape(-1).long()
    counts = torch.bincount(flat_e, minlength=E)
    aligned = (counts + tm - 1) // tm * tm
    ends = torch.cumsum(aligned, 0)
    group_start = ends - aligned
    order = torch.sort(flat_e, stable=True).indices
    rank = torch.empty_like(flat_e)
    rank[order] = torch.arange(TK, device=idx.device) \
        - (torch.cumsum(counts, 0) - counts)[flat_e[order]]
    dest = group_start[flat_e] + rank
    tile_rows = torch.arange(Tp // tm, device=idx.device) * tm
    tile_expert = torch.searchsorted(ends, tile_rows, right=True)
    tile_expert = torch.clamp(tile_expert, max=E - 1).to(torch.int32)
    return dest, tile_expert, Tp


def moe_ffn(x: torch.Tensor,      # (T, D)
            gate: torch.Tensor,   # (T, K)
            idx: torch.Tensor,    # (T, K) int
            wg: torch.Tensor, wu: torch.Tensor,   # (E, D, F)
            wd: torch.Tensor,                     # (E, F, D)
            tm: int = 128) -> torch.Tensor:
    """The routed expert FFN in ``x.dtype``: three grouped matmuls (K4 on
    CUDA tensors) over the expert-sorted, tile-aligned rows; ``h = silu(g)
    * u`` is rounded to ``x.dtype`` before the down projection, as in the
    reference."""
    T, D = x.shape
    K = idx.shape[1]
    E, _, F = wg.shape
    dest, tile_expert, Tp = _route(idx, T, K, E, tm)
    flat_t = torch.arange(T, device=x.device).repeat_interleave(K)
    xs = torch.zeros((Tp, D), dtype=x.dtype, device=x.device)
    xs[dest] = x[flat_t]
    g = gmm_cuda(xs, wg, tile_expert, tm=tm)
    u = gmm_cuda(xs, wu, tile_expert, tm=tm)
    h = (torch.nn.functional.silu(g) * u).to(x.dtype)
    y = gmm_cuda(h, wd, tile_expert, tm=tm)   # (Tp, D)
    contrib = y[dest] * gate.reshape(-1).float()[:, None]
    out = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    return out.index_add_(0, flat_t, contrib).to(x.dtype)


def moe_ffn_oracle(x, gate, idx, wg, wu, wd):
    return moe_ffn_ref(x, gate, idx, wg, wu, wd)
