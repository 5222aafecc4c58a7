"""Plain torch versions of the BCSR SpMM kernel.

``bsr_spmm_ref`` is the counterpart of ``repro.kernels.bsr_spmm.ref``
(dense tiles).  ``bsr_spmm_plain`` computes exactly what the CUDA kernel
(K3) computes from the packed tiles, epilogue included: the wrapper in
``kernel.py`` runs it for CPU tensors, and the kernel is held against it
on the card.  Both write out of place, so that they batch under
``torch.func.vmap``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.common import apply_epilogue_inregister
from repro_torch.sparse.formats import PackedBCSR

#: Entries multiplied at a time by the plain version, so that its products
#: stay near 1 GB at N = 128.
_CHUNK = 1 << 21


def bsr_spmm_ref(blocks: torch.Tensor, block_col: torch.Tensor,
                 block_row: torch.Tensor, dense: torch.Tensor,
                 num_block_rows: int) -> torch.Tensor:
    """out[br*bm:(br+1)*bm, :] += blocks[k] @ dense[block_col[k]*bk:..., :]
    for every stored block k with block_row[k] == br; f32 out of shape
    (num_block_rows * bm, N)."""
    nnzb, bm, bk = blocks.shape
    n = dense.shape[1]
    rhs = dense.reshape(dense.shape[0] // bk, bk, n)[block_col.long()]
    prod = torch.einsum("kij,kjn->kin", blocks.float(), rhs.float())
    out = torch.zeros((num_block_rows, bm, n), dtype=torch.float32,
                      device=blocks.device)
    out = out.index_add(0, block_row.long(), prod)
    return out.reshape(num_block_rows * bm, n)


def bsr_spmm_plain(packed: PackedBCSR, dense: torch.Tensor, *,
                   out_rows: Optional[int] = None,
                   bias: Optional[torch.Tensor] = None,
                   bias_kind: Optional[str] = None,
                   epilogue: Optional[str] = None) -> torch.Tensor:
    """What K3 computes: the f32 product of the packed tiles with
    ``dense``, whose rows past its end read as zeros, for the first
    ``out_rows`` rows, then ``epilogue(acc + bias)`` with a row bias
    (``bias[row]``) or a column bias (``bias[col]``) — on every row, a
    block row without entries too."""
    bm, bk = packed.block_shape
    n = dense.shape[1]
    block_rows = packed.block_rows
    rows = block_rows * bm if out_rows is None else out_rows
    dev = packed.val.device
    tile = torch.repeat_interleave(
        torch.arange(packed.nblocks, device=dev),
        torch.diff(packed.tile_ptr), output_size=packed.nnz)
    brow = torch.repeat_interleave(
        torch.arange(block_rows, device=dev),
        torch.diff(packed.block_rowptr).long(), output_size=packed.nblocks)
    d = dense.float()
    out = torch.zeros((block_rows * bm, n), dtype=torch.float32, device=dev)
    for s in range(0, packed.nnz, _CHUNK):
        t = tile[s:s + _CHUNK]
        loc = packed.local[s:s + _CHUNK].long()
        k = packed.block_col[t].long() * bk + loc % bk
        inside = k < d.shape[0]
        row = brow[t] * bm + torch.div(loc, bk, rounding_mode="floor")
        prod = packed.val[s:s + _CHUNK].float()[inside, None] * d[k[inside]]
        out = out.index_add(0, row[inside], prod)
        del prod
    out = out[:rows]
    if bias is not None:
        bias = bias[:rows, None] if bias_kind == "row" else bias[None, :]
    return apply_epilogue_inregister(out, bias, epilogue)
