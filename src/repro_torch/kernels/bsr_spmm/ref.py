"""Plain torch versions of the BCSR SpMM kernel.

``bsr_spmm_ref`` is the counterpart of ``repro.kernels.bsr_spmm.ref``.
``bsr_spmm_plain`` computes exactly what the CUDA kernel (K3) computes,
epilogue included: the wrapper in ``kernel.py`` runs it for CPU tensors,
and the kernel is held against it on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.common import apply_epilogue_inregister

#: Tiles multiplied at a time by the plain version, so that its
#: intermediates stay near 0.3 GB at 128x128 tiles and N = 128.
_CHUNK = 4096


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
    out.index_add_(0, block_row.long(), prod)
    return out.reshape(num_block_rows * bm, n)


def bsr_spmm_plain(blocks: torch.Tensor, block_col: torch.Tensor,
                   block_rowptr: torch.Tensor, dense: torch.Tensor, *,
                   out_rows: Optional[int] = None,
                   bias: Optional[torch.Tensor] = None,
                   bias_kind: Optional[str] = None,
                   epilogue: Optional[str] = None) -> torch.Tensor:
    """What K3 computes: the f32 product of the tiles with ``dense``, whose
    rows past its end read as zeros, for the first ``out_rows`` rows, then
    ``epilogue(acc + bias)`` with a row bias (``bias[row]``) or a column
    bias (``bias[col]``) — on every row, a block row without tiles too."""
    nnzb, bm, bk = blocks.shape
    n = dense.shape[1]
    block_rows = block_rowptr.shape[0] - 1
    rows = block_rows * bm if out_rows is None else out_rows
    need = (int(block_col.max()) + 1) * bk if nnzb else 0
    d = dense.float()
    if need > d.shape[0]:
        d = torch.nn.functional.pad(d, (0, 0, 0, need - d.shape[0]))
    d = d[: d.shape[0] // bk * bk].reshape(-1, bk, n)
    brow = torch.repeat_interleave(
        torch.arange(block_rows, device=blocks.device),
        torch.diff(block_rowptr).long(), output_size=nnzb)
    out = torch.zeros((block_rows, bm, n), dtype=torch.float32,
                      device=blocks.device)
    for s in range(0, nnzb, _CHUNK):
        e = min(s + _CHUNK, nnzb)
        prod = torch.bmm(blocks[s:e].float(), d[block_col[s:e].long()])
        out.index_add_(0, brow[s:e], prod)
        del prod
    out = out.reshape(block_rows * bm, n)[:rows]
    if bias is not None:
        bias = bias[:rows, None] if bias_kind == "row" else bias[None, :]
    return apply_epilogue_inregister(out, bias, epilogue)
