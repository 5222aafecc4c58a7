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
packed on each call.  A dense operand of a ``torch.func`` transform goes
through the custom op ``lilac_torch::bsr_spmm``, whose ``register_vmap``
rule lays a batch of them (under ``torch.func.vmap``) side by side as
columns: one launch; a plain one calls the wrapper directly, sparing the
host the op's dispatch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.kernels.bsr_spmm.kernel import bsr_spmm_cuda
from repro_torch.kernels.bsr_spmm.ref import bsr_spmm_ref
from repro_torch.kernels.common import apply_epilogue_inregister, vmap_by_loop
from repro_torch.sparse.formats import BCSR, PackedBCSR, pack_bcsr, rebuilt
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
    dense = dense.to(dtype).contiguous()
    if not torch._C._functorch.is_functorch_wrapped_tensor(dense):
        return bsr_spmm_cuda(packed, dense, out_rows=rows, bias=bias,
                             bias_kind=kind, epilogue=epilogue)
    return bsr_spmm_op(packed.val, packed.local, packed.tile_ptr,
                       packed.row_start, packed.col_mask, packed.block_col,
                       packed.block_rowptr, dense, bias, packed.shape[0],
                       packed.shape[1], packed.block_shape[0],
                       packed.block_shape[1], rows, kind, epilogue)


@torch.library.custom_op("lilac_torch::bsr_spmm", mutates_args=())
def bsr_spmm_op(val: torch.Tensor, local: torch.Tensor,
                tile_ptr: torch.Tensor, row_start: torch.Tensor,
                col_mask: torch.Tensor, block_col: torch.Tensor,
                block_rowptr: torch.Tensor, dense: torch.Tensor,
                bias: Optional[torch.Tensor], rows: int, cols: int, bm: int,
                bk: int, out_rows: int, bias_kind: Optional[str],
                epilogue: Optional[str]) -> torch.Tensor:
    """K3's launch on a ``PackedBCSR`` given by its tensors (checked when
    it was built): ``(out_rows, N)`` f32.  Its vmap rule takes a batch of
    dense operands as one launch, the batch laid side by side as columns
    (``(K, B·N)``, a batch of vectors ``(K, B)``), and a batched matrix or
    bias as one launch an element.  It has no autograd formula: the
    harnesses that call it run inside their ``vjp`` clause's Function."""
    packed = rebuilt(PackedBCSR, val=val, local=local, tile_ptr=tile_ptr,
                     row_start=row_start, col_mask=col_mask,
                     block_col=block_col, block_rowptr=block_rowptr,
                     shape=(rows, cols), block_shape=(bm, bk))
    return bsr_spmm_cuda(packed, dense, out_rows=out_rows, bias=bias,
                         bias_kind=bias_kind, epilogue=epilogue)


@bsr_spmm_op.register_fake
def _bsr_spmm_fake(val, local, tile_ptr, row_start, col_mask, block_col,
                   block_rowptr, dense, bias, rows, cols, bm, bk, out_rows,
                   bias_kind, epilogue):
    return dense.new_empty((out_rows, dense.shape[1]), dtype=torch.float32)


@bsr_spmm_op.register_vmap
def _bsr_spmm_vmap(info, in_dims, *args):
    if any(d is not None for i, d in enumerate(in_dims) if i != 7):
        return vmap_by_loop(bsr_spmm_op, info, in_dims, args)
    a = list(args)
    dense = args[7].movedim(in_dims[7], 0)              # (B, K, N)
    b, k, n = dense.shape
    a[7] = dense.permute(1, 0, 2).reshape(k, b * n).contiguous()
    if a[8] is not None and a[14] == "col":
        a[8] = a[8].repeat(b)                           # a bias a column
    out = bsr_spmm_op(*a)                               # (rows, B·N)
    return out.reshape(out.shape[0], b, n).movedim(1, 0), 0


def bsr_spmm_oracle(bcsr: BCSR, dense: torch.Tensor) -> torch.Tensor:
    block_row = row_ids_from_row_ptr(bcsr.block_rowptr, bcsr.nblocks)
    out = bsr_spmm_ref(bcsr.blocks, bcsr.block_col, block_row, dense,
                       bcsr.block_rows)
    return out[: bcsr.shape[0]]
