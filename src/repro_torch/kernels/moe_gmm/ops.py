"""Routing, sort, group alignment and the three grouped matmuls of the MoE
expert FFN.

Counterpart of ``repro.kernels.moe_gmm.ops``.  ``moe_ffn`` is exact with
respect to the naive dense-dispatch oracle (no capacity drops) while
doing ~E/K times less matmul work.  The gated combine stays plain torch
(a sum over each token's K pairs), as the reference leaves it to XLA.

``lilac_torch::moe_ffn`` is ``moe_ffn`` as a ``torch.library`` custom op
(with a fake kernel that gives its output's shape and dtype), the form in
which the ``cuda.gmm`` harness appears in a trace-mode graph: its shapes
are static (``Tp`` is the worst case), it mutates no input and it needs
no host sync, so ``make_fx``, ``torch.compile`` and CUDA-graph capture
pass through it.  Its autograd formula (``register_autograd``) is the
``vjp`` clause's body, ``harness.BUILTIN_VJPS["moe_ffn_bwd"]``: the
capacity-bucket dispatch recomputed under ``torch.func.vjp`` at a capacity
no expert's load exceeds, nothing dropped (K4 has no backward).  Its
``register_vmap`` rule runs a batch of token groups (the MoE block's
``torch.func.vmap`` over sequences) as one call over all their tokens.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import torch

from repro_torch.kernels.common import differentiable, vmap_by_loop
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
    # a scatter, not torch.bincount, which reads the largest id back to
    # the host: the op must not sync (CUDA-graph capture)
    counts = torch.zeros(E, dtype=torch.long, device=idx.device) \
        .scatter_add_(0, flat_e, torch.ones_like(flat_e))
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
    contrib = y[dest] * gate.reshape(-1).to(y.dtype)[:, None]
    # a token's K pairs are consecutive rows: sum them in a fixed order (an
    # index_add_ on the card adds them atomically in whatever order the
    # threads land, and a call would not repeat its own bits)
    return contrib.reshape(T, K, D).sum(dim=1).to(x.dtype)


@torch.library.custom_op("lilac_torch::moe_ffn", mutates_args=())
def moe_ffn_op(x: torch.Tensor, gate: torch.Tensor, idx: torch.Tensor,
               wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
               tm: int) -> torch.Tensor:
    """:func:`moe_ffn` as a custom op: (T, D) in ``x.dtype``."""
    return moe_ffn(x, gate, idx, wg, wu, wd, tm=tm)


@moe_ffn_op.register_fake
def _moe_ffn_fake(x, gate, idx, wg, wu, wd, tm):
    return torch.empty_like(x)


def _moe_ffn_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:6])


def _moe_ffn_backward(ctx, ct):
    from repro_torch.core.harness import BUILTIN_VJPS

    x, gate, idx, wg, wu, wd = ctx.saved_tensors
    b = {"x": x, "gate": gate, "idx": idx, "wg": wg, "wu": wu, "wd": wd,
         "experts": wg.shape[0]}
    g = BUILTIN_VJPS["moe_ffn_bwd"](b, None, None, ct)
    return g["x"], g["gate"], None, g["wg"], g["wu"], g["wd"], None


moe_ffn_op.register_autograd(_moe_ffn_backward, setup_context=_moe_ffn_setup)


def _moe_ffn_batch(fn, info, in_dims, x, gate, idx, wg, wu, wd, tm):
    """A batch of token groups (``torch.func.vmap`` over sequences) as one
    call over the flattened tokens: the function is per token, so each
    token's row is the same arithmetic, and K4 launches 3 times, not 3·B.
    Batched weights: one call an element."""
    args = (x, gate, idx, wg, wu, wd, tm)
    if any(d is not None for d in in_dims[3:]):
        return vmap_by_loop(fn, info, in_dims, args)
    b = info.batch_size

    def tokens(t, d):
        t = t.movedim(d, 0) if d is not None else t.expand(b, *t.shape)
        return t.reshape(-1, t.shape[-1])

    x2, g2, i2 = (tokens(t, d) for t, d in zip(args[:3], in_dims[:3]))
    out = fn(x2, g2, i2, wg, wu, wd, tm)
    return out.reshape(b, -1, out.shape[-1]), 0


moe_ffn_op.register_vmap(functools.partial(_moe_ffn_batch, moe_ffn_op))
#: ``moe_ffn_op`` differentiable under every transform
moe_ffn_call = differentiable(moe_ffn_op, _moe_ffn_setup, _moe_ffn_backward,
                              _moe_ffn_batch)


def moe_ffn_oracle(x, gate, idx, wg, wu, wd):
    return moe_ffn_ref(x, gate, idx, wg, wu, wd)
