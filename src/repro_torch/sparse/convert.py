"""Format conversions used as marshaled invariants (LiLAC-How INPUTs).

Counterpart of ``repro.sparse.convert``.  Each conversion is expensive
relative to one SpMV, so the data plane (``repro_torch.core.marshal``)
memoizes them keyed on the source arrays' fingerprints.
"""
from __future__ import annotations

import torch

from repro_torch.sparse.formats import (BCSR, CSR, ELL, JDS, PackedBCSR,
                                        ell_from_csr, jds_from_csr,
                                        packed_bcsr)


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


def csr_to_packed_bcsr(csr: CSR, block_shape=(128, 128)) -> PackedBCSR:
    """CSR -> the packed BCSR layout, on the CSR's device, with one sort of
    the entries and no dense tile anywhere.

    The tiles are ``csr_to_bcsr``'s, tile for tile, and so are the values:
    each entry's key is (tile, i, k), so one stable sort orders the entries
    as the layout stores them and brings duplicates together, in CSR
    order; they are summed as ``csr_to_bcsr`` sums them and zero sums are
    dropped.  A block row with no entry keeps one tile at block column 0,
    with no entries; each tile's place follows from counts, not a sort.
    """
    bm, bk = block_shape
    if bm * bk > 1 << 16:
        raise ValueError(f"tiles of {bm}x{bk} do not take 16-bit local ids")
    rows, cols = csr.shape
    dev = csr.val.device
    block_rows = -(-rows // bm)
    block_cols = -(-cols // bk)
    row = torch.repeat_interleave(
        torch.arange(rows, device=dev), torch.diff(csr.row_ptr).long(),
        output_size=csr.nnz)
    col = csr.col_ind.long()
    key = ((torch.div(row, bm, rounding_mode="floor") * block_cols
            + torch.div(col, bk, rounding_mode="floor")) * bm
           + row % bm) * bk + col % bk
    del row, col
    key, order = torch.sort(key, stable=True)
    n = key.shape[0]
    new = torch.ones(n, dtype=torch.bool, device=dev)
    new[1:] = key[1:] != key[:-1]
    run = torch.cumsum(new, 0) - 1
    key = key[new]
    val = torch.zeros(key.shape[0], dtype=csr.val.dtype,
                      device=dev).index_add_(0, run, csr.val[order])
    del order, run, new
    nz = val != 0
    key, val = key[nz], val[nz]
    tile_key = torch.div(key, bm * bk, rounding_mode="floor")
    local = key - tile_key * (bm * bk)
    # the kept tiles, and an empty tile at block column 0 for each block
    # row that has none, in (block row, block column) order
    new = torch.ones(tile_key.shape[0], dtype=torch.bool, device=dev)
    new[1:] = tile_key[1:] != tile_key[:-1]
    kept = tile_key[new]
    kept_row = torch.div(kept, block_cols, rounding_mode="floor")
    counts = torch.bincount(kept_row, minlength=block_rows)
    block_rowptr = torch.zeros(block_rows + 1, dtype=torch.int64, device=dev)
    block_rowptr[1:] = torch.cumsum(counts.clamp(min=1), 0)
    kept_first = torch.cumsum(counts, 0) - counts
    place = block_rowptr[kept_row] + torch.arange(
        kept.shape[0], device=dev) - kept_first[kept_row]
    nblocks = int(block_rowptr[-1])
    block_col = torch.zeros(nblocks, dtype=torch.int32, device=dev)
    block_col[place] = (kept % block_cols).to(torch.int32)
    tile = place[torch.cumsum(new, 0) - 1]
    return packed_bcsr(val, tile, local, block_col,
                       block_rowptr.to(torch.int32),
                       (block_rows * bm, block_cols * bk), (bm, bk))
