"""Shape normalisation and variant choice for the ELL SpMV kernels.

Counterpart of ``repro.kernels.spmv_ell.ops``: the slab geometry (row
padding and the clamp for tiny row counts), the resident / column-windowed
split at ``RESIDENT_VEC_LIMIT``, the slab-compacted column-window layout,
and the unfused fallback for a bias that is not 1-D.

The split decides two things.  A user's ELL/JDS arrays (``spmv_ell``)
take K1's direct body within the limit and K2 beyond it.  A marshaled CSR
(``pack_ell128`` / ``spmv_ell_packed``) is kept only as the slab-compacted
column-window layout: within the limit at a window that fits shared memory
(``staged_window``), run by K1's staged body; beyond it at 65,536 columns,
run by K2.  The kernels mask the ragged last slab themselves, so row
padding sets the launch grid and copies nothing.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.common import apply_epilogue_inregister
from repro_torch.kernels.spmv_ell.kernel import (STAGE_BYTES, spmv_ell_cuda,
                                                 spmv_ell_staged_cuda,
                                                 spmv_ell_windowed_cuda)
from repro_torch.sparse.convert import csr_to_ell
from repro_torch.sparse.formats import (CSR, SEG_WIDTH, WINDOW,
                                        WindowedELL, ell_windows)

# Vector sizes above this use the column-windowed kernel.
RESIDENT_VEC_LIMIT = 1 << 20  # 1M elements (4 MiB f32)
# Rows a thread block covers (the reference's default slab).
ROWS_PER_SLAB = 32


def slab_geometry(rows: int, rows_per_slab: int) -> Tuple[int, int]:
    """(rows per slab, padded rows): rows pad to a whole number of slabs,
    and a matrix with fewer rows than a slab gets the largest power-of-two
    slab (at least 8) that its rows fill."""
    pad = (-rows) % rows_per_slab
    if 0 < rows < rows_per_slab:
        rows_per_slab = max(8, 1 << int(math.floor(math.log2(rows))))
        pad = (-rows) % rows_per_slab
    return rows_per_slab, rows + pad


def _fusable(bias, out_rows: int) -> bool:
    return bias is None or (isinstance(bias, torch.Tensor) and bias.dim() == 1
                            and bias.shape[0] == out_rows)


def spmv_ell(val: torch.Tensor, col: torch.Tensor, vec: torch.Tensor,
             rows_per_slab: int = ROWS_PER_SLAB,
             epilogue: Optional[str] = None,
             bias=None,
             perm: Optional[torch.Tensor] = None,
             out_rows: Optional[int] = None) -> torch.Tensor:
    """ELL SpMV: ``out[o(i)] = epilogue(sum_j val[i,j]*vec[col[i,j]] +
    bias)``, ``o = perm`` or the identity.  A bias the kernels cannot index
    per output row (scalar, broadcast-shaped) applies after the kernel:
    still right, just unfused."""
    rows = val.shape[0]
    n_out = rows if perm is None or out_rows is None else out_rows
    if bias is not None and not _fusable(bias, n_out):
        out = spmv_ell(val, col, vec, rows_per_slab=rows_per_slab, perm=perm,
                       out_rows=out_rows)
        return apply_epilogue_inregister(out, bias, epilogue)
    if bias is not None:
        bias = bias.float().contiguous()
    if vec.shape[0] <= RESIDENT_VEC_LIMIT:
        rows_per_slab, _ = slab_geometry(rows, rows_per_slab)
        return spmv_ell_cuda(val, col, vec, bias=bias, perm=perm,
                             out_rows=out_rows, epilogue=epilogue,
                             rows_per_slab=rows_per_slab)
    return _windowed(val, col, vec, rows_per_slab, epilogue=epilogue,
                     bias=bias, perm=perm, out_rows=out_rows)


def _windowed(val, col, vec, rows_per_slab, window: int = WINDOW,
              epilogue: Optional[str] = None, bias=None, perm=None,
              out_rows: Optional[int] = None,
              layout: Optional[WindowedELL] = None):
    """Compact the slots by slab and column window (unless ``layout``
    already holds them) and run the windowed kernel.  ``rows_per_slab`` is
    the reference's argument and sets nothing here: the layout's slab is a
    warp's 32 rows (``formats.SLAB``), and the kernel masks a ragged
    last slab itself."""
    if layout is None:
        layout = ell_windows(val, col, vec.shape[0], window)
    return spmv_ell_windowed_cuda(layout, vec, bias=bias, perm=perm,
                                  out_rows=out_rows, epilogue=epilogue)


def staged_window(cols: int, element_size: int) -> int:
    """The column window of K1's staged body: the vector's columns in as
    few windows as fit ``STAGE_BYTES`` of shared memory (and 16-bit local
    ids), split evenly and rounded up to ``SEG_WIDTH`` so that each window
    starts on a 16-byte boundary (50,000 for NAS CG class C's 150,000 f32
    columns)."""
    most = min(WINDOW, STAGE_BYTES // element_size) // SEG_WIDTH * SEG_WIDTH
    n_windows = max(1, -(-cols // most))
    return -(-max(1, -(-cols // n_windows)) // SEG_WIDTH) * SEG_WIDTH


def pack_ell128(csr: CSR) -> WindowedELL:
    """The marshaled form of a CSR matrix that the kernels read: the
    slab-compacted column-window layout of its lane-128 ELL (the JDS row
    sort kept as ``perm``), at ``staged_window`` for a vector within
    ``RESIDENT_VEC_LIMIT`` and at 65,536 columns beyond it.  Neither
    kernel reads the ELL or its padding, so they are not kept."""
    ell = csr_to_ell(csr, lane=128)
    window = staged_window(csr.cols, ell.val.element_size()) \
        if csr.cols <= RESIDENT_VEC_LIMIT else WINDOW
    return ell_windows(ell.val, ell.col, csr.cols, window=window,
                       perm=ell.perm)


def spmv_ell_packed(packed: WindowedELL, vec: torch.Tensor,
                    epilogue: Optional[str] = None,
                    bias=None) -> torch.Tensor:
    """SpMV with a :func:`pack_ell128` value: K1's staged body within
    ``RESIDENT_VEC_LIMIT`` columns, K2 beyond; the kernel un-permutes the
    JDS row sort in its store."""
    rows = packed.shape[0]
    if bias is not None and not _fusable(bias, rows):
        out = spmv_ell_packed(packed, vec)
        return apply_epilogue_inregister(out, bias, epilogue)
    if bias is not None:
        bias = bias.float().contiguous()
    run = spmv_ell_staged_cuda if packed.shape[1] <= RESIDENT_VEC_LIMIT \
        else spmv_ell_windowed_cuda
    return run(packed, vec, bias=bias, perm=packed.perm, out_rows=rows,
               epilogue=epilogue)
