"""Ragged batch packing for the sparse-MoE / grouped-matmul path.

Counterpart of ``repro.serve.packing``.  Requests in a serving batch carry
different token counts (chunked prefill, speculative verification, mixed
prompt tails).  The dense way to batch them is per-request padding —
``(R, T_max, D)`` with every short request padded to the longest — which
wastes FLOPs and routes *padding tokens* through the MoE router into the
expert buckets.

The grouped matmul (K4, ``repro_torch.kernels.moe_gmm``) does not need a
rectangle: it takes a FLAT ``(T, D)`` token batch and groups rows by
expert itself (sort + group-aligned tiles).  So the ragged pack is a
concatenation: the requests' tokens laid end to end, one grouped call
over exactly ``sum(T_i)`` tokens, and each request's output sliced back
out by offset.  A token's arithmetic does not depend on the batch's
layout, so the packed outputs equal the per-request results.

``moe_ffn_ragged`` is the entry point (K4 on CUDA tensors, its plain
version ``gmm_ref`` on CPU tensors); ``pack`` / ``unpack`` are the layout
helpers; ``padding_waste`` says what the rectangle would have burned.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def pack(parts: Sequence[Any]) -> Tuple[torch.Tensor, np.ndarray]:
    """Concatenate ragged ``(T_i, ...)`` tensors into one flat tensor plus
    the ``(R+1,)`` offset table (``flat[offsets[i]:offsets[i+1]]`` is
    request ``i``)."""
    if not parts:
        raise ValueError("nothing to pack")
    parts = [torch.as_tensor(p) for p in parts]
    lengths = [int(p.shape[0]) for p in parts]
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    return torch.cat(parts, dim=0), offsets


def unpack(flat: Any, offsets: np.ndarray) -> List[Any]:
    """Inverse of :func:`pack`."""
    return [flat[int(offsets[i]):int(offsets[i + 1])]
            for i in range(len(offsets) - 1)]


def padding_waste(lengths: Sequence[int],
                  pad_to: Optional[int] = None) -> float:
    """Fraction of a padded-rectangle batch that is padding: what the
    per-request-padded layout wastes relative to the ragged pack."""
    lengths = [int(x) for x in lengths]
    if not lengths:
        return 0.0
    tmax = max(max(lengths), pad_to or 0)
    total = tmax * len(lengths)
    return 1.0 - sum(lengths) / total


def moe_ffn_ragged(xs: Sequence[Any], gates: Sequence[Any],
                   idxs: Sequence[Any], wg, wu, wd, *,
                   backend: str = "gmm") -> List[Any]:
    """One grouped-matmul call over the ragged pack of ``R`` requests.

    ``xs[i]``: (T_i, D); ``gates[i]``/``idxs[i]``: (T_i, K).  Returns the
    per-request ``(T_i, D)`` outputs.  ``backend="gmm"`` feeds
    ``kernels.moe_gmm.ops.moe_ffn`` directly (K4 on CUDA tensors, its
    plain version on CPU tensors; group-by-expert packing happens inside);
    ``backend="naive"`` is the dense-dispatch oracle the tests compare
    against.
    """
    flat_x, offsets = pack(xs)
    flat_g, _ = pack(gates)
    flat_i, _ = pack(idxs)
    if backend == "gmm":
        from repro_torch.kernels.moe_gmm import ops as gmm_ops
        out = gmm_ops.moe_ffn(flat_x, flat_g, flat_i, wg, wu, wd)
    elif backend == "naive":
        from repro_torch.models.layers import _moe_naive_2d
        out = _moe_naive_2d(flat_x, flat_g, flat_i, wg, wu, wd)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    return unpack(out, offsets)


def moe_ffn_padded(xs: Sequence[Any], gates: Sequence[Any],
                   idxs: Sequence[Any], wg, wu, wd) -> List[Any]:
    """The per-request-padded baseline: pad every request to ``T_max``,
    run the rectangle (the naive dense dispatch, request by request, as
    the reference's ``vmap`` does), slice the padding back off.  Routing
    gates of the padding rows are zeroed so padding cannot contaminate
    real tokens — the cost is pure wasted work, which is the point being
    measured."""
    from repro_torch.models.layers import _moe_naive_2d
    xs, gates, idxs = ([torch.as_tensor(a) for a in t]
                       for t in (xs, gates, idxs))
    lengths = [int(x.shape[0]) for x in xs]
    tmax = max(lengths)

    def padrow(a):
        return F.pad(a, (0, 0) * (a.dim() - 1) + (0, tmax - a.shape[0]))

    px = torch.stack([padrow(x) for x in xs])               # (R, Tmax, D)
    pg = torch.stack([padrow(g) for g in gates])
    pi = torch.stack([padrow(i) for i in idxs])
    mask = torch.stack([torch.arange(tmax, device=px.device) < n
                        for n in lengths])
    pg = pg * mask[..., None].to(pg.dtype)
    out = torch.stack([_moe_naive_2d(px[r], pg[r], pi[r], wg, wu, wd)
                       for r in range(len(xs))])
    return [out[r, :lengths[r]] for r in range(len(xs))]
