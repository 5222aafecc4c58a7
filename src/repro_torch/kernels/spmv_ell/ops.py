"""Shape normalisation and variant choice for the ELL SpMV kernels.

Counterpart of ``repro.kernels.spmv_ell.ops``: the slab geometry (row
padding and the clamp for tiny row counts), the resident / column-windowed
split at ``RESIDENT_VEC_LIMIT``, the relayout into column windows, and the
unfused fallback for a bias that is not 1-D.  On Hopper the vector needs no
on-chip residency, but the split stays so the windowed kernel (K2) stays on
the path for long vectors.  The kernel masks the ragged last slab itself,
so row padding sets the launch grid and copies nothing.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels.common import apply_epilogue_inregister
from repro_torch.kernels.spmv_ell.kernel import (spmv_ell_cuda,
                                                 spmv_ell_windowed_cuda)
from repro_torch.sparse.convert import csr_to_ell
from repro_torch.sparse.formats import (CSR, ELL, WINDOW, WindowedELL,
                                        ell_windows)

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
    rows_per_slab, _ = slab_geometry(rows, rows_per_slab)
    if bias is not None:
        bias = bias.float().contiguous()
    if vec.shape[0] <= RESIDENT_VEC_LIMIT:
        return spmv_ell_cuda(val, col, vec, bias=bias, perm=perm,
                             out_rows=out_rows, epilogue=epilogue,
                             rows_per_slab=rows_per_slab)
    return _windowed(val, col, vec, rows_per_slab, epilogue=epilogue,
                     bias=bias, perm=perm, out_rows=out_rows)


def _windowed(val, col, vec, rows_per_slab, window: int = WINDOW,
              epilogue: Optional[str] = None, bias=None, perm=None,
              out_rows: Optional[int] = None,
              layout: Optional[WindowedELL] = None):
    """Split each row's slots by column window (unless ``layout`` already
    holds the split) and run the windowed kernel."""
    if layout is None:
        layout = ell_windows(val, col, vec.shape[0], window)
    return spmv_ell_windowed_cuda(layout.val, layout.col, vec,
                                  window=layout.window, bias=bias, perm=perm,
                                  out_rows=out_rows, epilogue=epilogue,
                                  rows_per_slab=rows_per_slab)


def pack_ell128(csr: CSR) -> Union[ELL, WindowedELL]:
    """The marshaled form of a CSR matrix that the kernels read: its
    lane-128 ELL, or, when its vector would exceed ``RESIDENT_VEC_LIMIT``,
    only that ELL's column-window relayout (the windowed kernel never reads
    the ELL itself, so it is not kept)."""
    ell = csr_to_ell(csr, lane=128)
    if csr.cols <= RESIDENT_VEC_LIMIT:
        return ell
    return ell_windows(ell.val, ell.col, csr.cols, perm=ell.perm)


def spmv_ell_packed(packed: Union[ELL, WindowedELL], vec: torch.Tensor,
                    epilogue: Optional[str] = None,
                    bias=None) -> torch.Tensor:
    """SpMV with a :func:`pack_ell128` value: the kernel un-permutes the
    JDS row sort in its store, and a column-window relayout runs on the
    windowed kernel as it is, without splitting the slots again."""
    rows = packed.shape[0]
    if bias is not None and not _fusable(bias, rows):
        out = spmv_ell_packed(packed, vec)
        return apply_epilogue_inregister(out, bias, epilogue)
    if not isinstance(packed, WindowedELL):
        return spmv_ell(packed.val, packed.col, vec, epilogue=epilogue,
                        bias=bias, perm=packed.perm, out_rows=rows)
    if bias is not None:
        bias = bias.float().contiguous()
    rows_per_slab, _ = slab_geometry(rows, ROWS_PER_SLAB)
    return _windowed(packed.val, packed.col, vec, rows_per_slab,
                     epilogue=epilogue, bias=bias, perm=packed.perm,
                     out_rows=rows, layout=packed)
