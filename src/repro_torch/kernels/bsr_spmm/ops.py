"""Dispatch for the BCSR SpMM kernel.

Counterpart of ``repro.kernels.bsr_spmm.ops``.  The reference pads N to
its column tile and, where a block row has no tile, applies the epilogue
after the kernel (its last-visit trigger would never fire there).  The
port's kernel masks the ragged N edge and the rows past ``out_rows``
itself, and writes ``epilogue(0 + bias)`` for a block row without tiles,
so the epilogue fuses whenever the bias is a row or a column vector, with
the reference's result.  A bias of any other shape (a scalar, a full
matrix) applies after the kernel, as in the reference.  The kernel reads
packed tiles (``formats.PackedBCSR``, what the ``cuda.bcsr`` repack
builds); a caller that holds dense tiles (``formats.BCSR``) has them
packed on each call.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.kernels.bsr_spmm.kernel import bsr_spmm_cuda
from repro_torch.kernels.bsr_spmm.ref import bsr_spmm_ref
from repro_torch.kernels.common import apply_epilogue_inregister
from repro_torch.sparse.formats import BCSR, PackedBCSR, pack_bcsr
from repro_torch.sparse.ops import row_ids_from_row_ptr


def _bias_kind(bias, rows: int, n: int) -> Optional[str]:
    """'row' or 'col' for a 1-D bias of ``rows`` or ``n`` (row first)."""
    if not isinstance(bias, torch.Tensor) or bias.dim() != 1:
        return None
    if bias.shape[0] == rows:
        return "row"
    if bias.shape[0] == n:
        return "col"
    return None


def bsr_spmm(bcsr: Union[BCSR, PackedBCSR], dense: torch.Tensor,
             epilogue: Optional[str] = None,
             bias=None,
             bias_kind: Optional[str] = None,
             out_rows: Optional[int] = None) -> torch.Tensor:
    """Block-sparse (BCSR) @ dense -> (out_rows, N) f32, ``out_rows``
    defaulting to ``bcsr.shape[0]``; ``dense`` may stop short of the
    padded column count (the missing rows read as zeros).  ``epilogue`` /
    ``bias`` apply the detected epilogue; ``bias_kind`` ('row' | 'col')
    disambiguates a 1-D bias when rows == N, which by default resolves
    row first."""
    rows = bcsr.shape[0] if out_rows is None else out_rows
    n = dense.shape[1]
    kind = None if bias is None else (
        bias_kind if bias_kind is not None else _bias_kind(bias, rows, n))
    if bias is not None and kind is None:
        out = bsr_spmm(bcsr, dense, out_rows=rows)
        return apply_epilogue_inregister(out, bias, epilogue)
    if bias is not None:
        bias = bias.float().contiguous()
    packed = pack_bcsr(bcsr) if isinstance(bcsr, BCSR) else bcsr
    dtype = torch.promote_types(packed.val.dtype, dense.dtype)
    if packed.val.dtype != dtype:
        packed = dataclasses.replace(packed, val=packed.val.to(dtype))
    return bsr_spmm_cuda(packed, dense.to(dtype).contiguous(),
                         out_rows=rows, bias=bias, bias_kind=kind,
                         epilogue=epilogue)


def bsr_spmm_oracle(bcsr: BCSR, dense: torch.Tensor) -> torch.Tensor:
    block_row = row_ids_from_row_ptr(bcsr.block_rowptr, bcsr.nblocks)
    out = bsr_spmm_ref(bcsr.blocks, bcsr.block_col, block_row, dense,
                       bcsr.block_rows)
    return out[: bcsr.shape[0]]
