"""Wrapper of the hand-written CUDA BCSR SpMM kernel (``csrc/bsr_spmm.cu``).

Counterpart of ``repro.kernels.bsr_spmm.kernel``:

  bsr_spmm_cuda  <- bsr_spmm_pallas  (K3, with the fused epilogue K5)

The kernel reads the CSR structure over tile rows (``block_rowptr``) where
the Pallas kernel reads one block-row id per tile: a CTA loops over its
own block row's tiles.  For tensors on the CPU the wrapper returns the
kernel's plain version (``ref.py``); for CUDA tensors it launches the
kernel on the current stream or raises.  ``LAUNCHES`` counts the launches.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import EPILOGUE_CODES, check_tensor, launched
from repro_torch.kernels.bsr_spmm.ref import bsr_spmm_plain

SOURCE = Path(__file__).parent / "csrc" / "bsr_spmm.cu"

#: kernel name -> launches since the last reset (a plain count).
LAUNCHES = {"bsr_spmm": 0}

#: Rows a CTA covers: the largest tile height the kernel takes.
MAX_BM = 128

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_BIAS_CODES = {None: 0, "row": 1, "col": 2}


def reset_launches() -> None:
    LAUNCHES["bsr_spmm"] = 0


def bsr_spmm_cuda(blocks: torch.Tensor, block_col: torch.Tensor,
                  block_rowptr: torch.Tensor, dense: torch.Tensor, *,
                  out_rows: Optional[int] = None,
                  bias: Optional[torch.Tensor] = None,
                  bias_kind: Optional[str] = None,
                  epilogue: Optional[str] = None) -> torch.Tensor:
    """K3: ``out[r*bm+i, c] = epilogue(sum over block row r's tiles t of
    (blocks[t] @ dense[block_col[t]*bk : +bk])[i, c] + bias)`` for the
    first ``out_rows`` rows (default: every block row's), f32 out.  Rows of
    ``dense`` past its end read as zeros.  ``bias_kind`` is 'row' (bias of
    ``out_rows``) or 'col' (bias of N)."""
    if blocks.device.type == "cpu":
        return bsr_spmm_plain(blocks, block_col, block_rowptr, dense,
                              out_rows=out_rows, bias=bias,
                              bias_kind=bias_kind, epilogue=epilogue)
    dev = blocks.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {dev}")
    if blocks.dtype not in _SUFFIX:
        raise TypeError(f"blocks must be float32 or bfloat16, got "
                        f"{blocks.dtype}")
    if blocks.dim() != 3 or dense.dim() != 2:
        raise ValueError(f"blocks must be (nnzb, bm, bk) and dense (K, N), "
                         f"got {tuple(blocks.shape)} and {tuple(dense.shape)}")
    if epilogue not in EPILOGUE_CODES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if bias_kind not in _BIAS_CODES or (bias is None) != (bias_kind is None):
        raise ValueError("bias and bias_kind ('row' | 'col') go together, "
                         f"got bias_kind={bias_kind!r}")
    nnzb, bm, bk = blocks.shape
    kdim, n = dense.shape
    block_rows = block_rowptr.shape[0] - 1
    if bm > MAX_BM:
        raise ValueError(f"tiles of {bm} rows exceed the kernel's {MAX_BM}")
    rows = block_rows * bm if out_rows is None else out_rows
    if not 0 <= rows <= block_rows * bm:
        raise ValueError(f"out_rows={rows} outside the {block_rows} block "
                         f"rows of {bm}")
    check_tensor("blocks", blocks, dev, blocks.dtype)
    check_tensor("block_col", block_col, dev, torch.int32, (nnzb,))
    check_tensor("block_rowptr", block_rowptr, dev, torch.int32,
                 (block_rows + 1,))
    check_tensor("dense", dense, dev, blocks.dtype)
    if bias is not None:
        check_tensor("bias", bias, dev, torch.float32,
                     (rows,) if bias_kind == "row" else (n,))
    out = torch.empty((rows, n), dtype=torch.float32, device=dev)
    if rows == 0 or n == 0:
        return out
    with torch.cuda.device(dev):
        err = build.entry_point(SOURCE, f"bsr_spmm_{_SUFFIX[blocks.dtype]}",
                                6, 7)(
            blocks.data_ptr(), block_col.data_ptr(), block_rowptr.data_ptr(),
            dense.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), bm, bk, kdim, n, rows, _BIAS_CODES[bias_kind],
            EPILOGUE_CODES[epilogue], torch.cuda.current_stream().cuda_stream)
    launched(LAUNCHES, "bsr_spmm", err)
    return out
