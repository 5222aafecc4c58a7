"""Format conversions used as marshaled invariants (LiLAC-How INPUTs).

Counterpart of ``repro.sparse.convert``.  Each conversion is expensive
relative to one SpMV, so the data plane (``repro_torch.core.marshal``)
memoizes them keyed on the source arrays' fingerprints.
"""
from __future__ import annotations

import torch

from repro_torch.sparse.formats import (BCSR, CSR, ELL, JDS, ell_from_csr,
                                        jds_from_csr)


def csr_to_ell(csr: CSR, **kw) -> ELL:
    return ell_from_csr(csr, **kw)


def csr_to_jds(csr: CSR) -> JDS:
    return jds_from_csr(csr)


def csr_to_bcsr(csr: CSR, block_shape=(8, 128)) -> BCSR:
    """CSR -> BCSR with rows and columns padded to whole tiles, built on
    the CSR's device straight from its entries.

    The reference densifies the whole matrix and tiles it
    (``repro.sparse.convert.csr_to_bcsr``); at HPCG's 1.1 M rows that
    dense matrix would take ~5 TB.  Here duplicate (row, col) entries are
    summed first, as ``CSR.todense`` sums them; a tile is kept when one of
    its summed entries is nonzero; tiles are ordered by block row, then
    block column; an empty block row keeps one explicit zero tile at block
    column 0; and one scatter writes the entries into the kept tiles.  The
    bytes are the reference's (tests/test_torch_bsr_spmm.py).
    """
    bm, bk = block_shape
    rows, cols = csr.shape
    dev = csr.val.device
    block_rows = -(-rows // bm)
    block_cols = -(-cols // bk)
    row = torch.repeat_interleave(
        torch.arange(rows, device=dev), torch.diff(csr.row_ptr).long(),
        output_size=csr.nnz)
    col = csr.col_ind.long()
    # sum duplicates: one value per distinct (row, col), in CSR order
    lin, inv = torch.unique(row * cols + col, return_inverse=True)
    val = torch.zeros(lin.shape[0], dtype=csr.val.dtype,
                      device=dev).index_add_(0, inv, csr.val)
    nz = val != 0
    lin, val = lin[nz], val[nz]
    row = torch.div(lin, cols, rounding_mode="floor")
    col = lin - row * cols
    tile = torch.div(row, bm, rounding_mode="floor") * block_cols \
        + torch.div(col, bk, rounding_mode="floor")
    kept = torch.unique(tile)
    # block rows without a kept tile get tile (block row, 0)
    has = torch.zeros(block_rows, dtype=torch.bool, device=dev)
    has[torch.div(kept, block_cols, rounding_mode="floor")] = True
    empty = torch.nonzero(~has).reshape(-1) * block_cols
    keys = torch.sort(torch.cat([kept, empty])).values
    blocks = torch.zeros((keys.shape[0], bm, bk), dtype=csr.val.dtype,
                         device=dev)
    slot = torch.searchsorted(keys, tile)
    blocks.view(-1)[(slot * bm + row % bm) * bk + col % bk] = val
    counts = torch.bincount(torch.div(keys, block_cols, rounding_mode="floor"),
                            minlength=block_rows)
    block_rowptr = torch.zeros(block_rows + 1, dtype=torch.int32, device=dev)
    block_rowptr[1:] = torch.cumsum(counts, 0)
    return BCSR(blocks=blocks, block_col=(keys % block_cols).to(torch.int32),
                block_rowptr=block_rowptr,
                shape=(block_rows * bm, block_cols * bk),
                block_shape=(bm, bk))
