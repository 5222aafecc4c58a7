"""Wrapper of the hand-written CUDA BCSR SpMM kernel (``csrc/bsr_spmm.cu``).

Counterpart of ``repro.kernels.bsr_spmm.kernel``:

  bsr_spmm_cuda  <- bsr_spmm_pallas  (K3, with the fused epilogue K5)

The Pallas kernel multiplies dense (bm, bk) tiles; this one reads the
packed tiles of ``formats.PackedBCSR`` (each tile's entries only, as a
value and a 16-bit tile-local id) and the CSR structure over tile rows
(``block_rowptr``) where the Pallas kernel reads one block-row id per
tile: a CTA loops over its own block row's tiles.  It has two bodies,
counted apart in ``LAUNCHES``: ``bsr_spmm_wide`` for N > 8 (a CTA per
block row and 128 columns, the operand's rows under each tile staged in
shared memory) and ``bsr_spmm_narrow`` for N <= 8 (a thread a row).  For
tensors on the CPU the wrapper returns the kernel's plain version
(``ref.py``); for CUDA tensors it launches the kernel on the current
stream or raises.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import EPILOGUE_CODES, check_tensor, launched
from repro_torch.kernels.bsr_spmm.ref import bsr_spmm_plain
from repro_torch.sparse.formats import PackedBCSR

SOURCE = Path(__file__).parent / "csrc" / "bsr_spmm.cu"

#: kernel body -> launches since the last reset (a plain count).
LAUNCHES = {"bsr_spmm_wide": 0, "bsr_spmm_narrow": 0}

#: The largest tile the kernel takes: a CTA's rows, and the operand rows
#: the wide body stages.
MAX_BM = MAX_BK = 128
#: The widest N the narrow body takes.
NARROW_N = 8

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_BIAS_CODES = {None: 0, "row": 1, "col": 2}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _staged_operand(dense: torch.Tensor) -> torch.Tensor:
    """``dense`` with a row stride the wide body can copy in 16-byte
    chunks: as it is when N is a multiple of a chunk and the data is
    16-byte aligned (the GNN's N = 128), else a zero-padded copy."""
    per_chunk = 16 // dense.element_size()
    n = dense.shape[1]
    if n % per_chunk == 0 and dense.data_ptr() % 16 == 0:
        return dense
    return torch.nn.functional.pad(dense, (0, (-n) % per_chunk)).clone()


def bsr_spmm_cuda(packed: PackedBCSR, dense: torch.Tensor, *,
                  out_rows: Optional[int] = None,
                  bias: Optional[torch.Tensor] = None,
                  bias_kind: Optional[str] = None,
                  epilogue: Optional[str] = None) -> torch.Tensor:
    """K3: ``out[r*bm+i, c] = epilogue(sum over block row r's tiles t of
    (A_t @ dense[block_col[t]*bk : +bk])[i, c] + bias)`` for the first
    ``out_rows`` rows (default: every block row's), f32 out, with A_t the
    packed tile t.  Rows of ``dense`` past its end read as zeros.
    ``bias_kind`` is 'row' (bias of ``out_rows``) or 'col' (bias of N).
    The layout bounded its offsets when it was built (``PackedBCSR``)."""
    val = packed.val
    if val.device.type == "cpu":
        return bsr_spmm_plain(packed, dense, out_rows=out_rows, bias=bias,
                              bias_kind=bias_kind, epilogue=epilogue)
    dev = val.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {dev}")
    if val.dtype not in _SUFFIX:
        raise TypeError(f"the tiles must be float32 or bfloat16, got "
                        f"{val.dtype}")
    if dense.dim() != 2:
        raise ValueError(f"dense must be (K, N), got {tuple(dense.shape)}")
    if epilogue not in EPILOGUE_CODES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if bias_kind not in _BIAS_CODES or (bias is None) != (bias_kind is None):
        raise ValueError("bias and bias_kind ('row' | 'col') go together, "
                         f"got bias_kind={bias_kind!r}")
    bm, bk = packed.block_shape
    kdim, n = dense.shape
    block_rows, nb = packed.block_rows, packed.nblocks
    if bm > MAX_BM or bk > MAX_BK:
        raise ValueError(f"tiles of {bm}x{bk} exceed the kernel's "
                         f"{MAX_BM}x{MAX_BK}")
    if packed.nnz >= 1 << 31:
        raise ValueError(f"{packed.nnz} entries: the kernel indexes them "
                         f"with 32-bit offsets")
    rows = block_rows * bm if out_rows is None else out_rows
    if not 0 <= rows <= block_rows * bm:
        raise ValueError(f"out_rows={rows} outside the {block_rows} block "
                         f"rows of {bm}")
    check_tensor("val", val, dev, val.dtype)
    check_tensor("local", packed.local, dev, torch.uint16, val.shape)
    check_tensor("tile_ptr", packed.tile_ptr, dev, torch.int64, (nb + 1,))
    check_tensor("row_start", packed.row_start, dev, torch.uint16, (nb, bm))
    check_tensor("col_mask", packed.col_mask, dev, torch.int32,
                 (nb, -(-bk // 32)))
    check_tensor("block_col", packed.block_col, dev, torch.int32, (nb,))
    check_tensor("block_rowptr", packed.block_rowptr, dev, torch.int32,
                 (block_rows + 1,))
    check_tensor("dense", dense, dev, val.dtype)
    if bias is not None:
        check_tensor("bias", bias, dev, torch.float32,
                     (rows,) if bias_kind == "row" else (n,))
    out = torch.empty((rows, n), dtype=torch.float32, device=dev)
    if rows == 0 or n == 0:
        return out
    body = "bsr_spmm_narrow" if n <= NARROW_N else "bsr_spmm_wide"
    if body == "bsr_spmm_wide":
        dense = _staged_operand(dense)
    with torch.cuda.device(dev):
        err = build.entry_point(SOURCE, f"bsr_spmm_{_SUFFIX[val.dtype]}",
                                10, 8)(
            val.data_ptr(), packed.local.data_ptr(),
            packed.tile_ptr.data_ptr(), packed.row_start.data_ptr(),
            packed.col_mask.data_ptr(), packed.block_col.data_ptr(),
            packed.block_rowptr.data_ptr(),
            dense.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), bm, bk, kdim, dense.shape[1], n, rows,
            _BIAS_CODES[bias_kind], EPILOGUE_CODES[epilogue],
            torch.cuda.current_stream().cuda_stream)
    launched(LAUNCHES, body, err)
    return out
