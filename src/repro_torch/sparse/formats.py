"""Sparse matrix containers (frozen dataclasses of tensors) and host-side
constructors.

Counterpart of ``repro.sparse.formats``.  The storage formats are the
paper's (§3.2 Fig. 4/5):

* CSR  — val / col_ind / row_ptr (paper Fig. 4)
* COO  — val / row / col
* JDS  — perm / nzcnt / jd_ptr / val / col_ind (paper Fig. 5)
* ELL  — row-padded: after the JDS nnz row sort, rows are padded to a
         lane-aligned width so a row is one contiguous slab
* WindowedELL — ELL compacted by 32-row slab and column window (SELL-32
         per window), with window-local column ids (the layout of the
         windowed SpMV kernel for long vectors)
* BCSR — block CSR: dense (bm, bk) tiles, CSR structure over tile rows
* PackedBCSR — BCSR's tile structure with each tile's entries stored
         alone (value and a 16-bit tile-local id), the layout of the BCSR
         SpMM kernel

The host constructors build in numpy, so their arrays are byte-identical
to the JAX package's, and hand back tensors on the device of their input.
Containers compare by identity (``eq=False``): element-wise tensor
equality has no truth value.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

#: Column window of the windowed ELL layout (vector elements per window).
WINDOW = 1 << 16
#: Rows of a slab of the windowed ELL layout (one warp's rows).
SLAB = 32
#: A windowed segment's width (slots a row) is a multiple of this.
SEG_WIDTH = 8


def _np(t) -> np.ndarray:
    """Host numpy view of a tensor (copies from the device)."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _t(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.require(a, requirements=["C", "W"])).to(device)


@dataclasses.dataclass(frozen=True, eq=False)
class CSR:
    """Compressed sparse row. row_ptr has length rows+1."""

    val: torch.Tensor      # (nnz,)
    col_ind: torch.Tensor  # (nnz,) int32
    row_ptr: torch.Tensor  # (rows+1,) int32
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return self.val.shape[0]

    @property
    def rows(self) -> int:
        return self.shape[0]

    @property
    def cols(self) -> int:
        return self.shape[1]

    def todense(self) -> torch.Tensor:
        rows, cols = self.shape
        row_ids = torch.repeat_interleave(
            torch.arange(rows, device=self.val.device),
            torch.diff(self.row_ptr).long(), output_size=self.nnz)
        out = torch.zeros((rows, cols), dtype=self.val.dtype,
                          device=self.val.device)
        return out.index_put_((row_ids, self.col_ind.long()), self.val,
                              accumulate=True)


@dataclasses.dataclass(frozen=True, eq=False)
class COO:
    val: torch.Tensor  # (nnz,)
    row: torch.Tensor  # (nnz,) int32
    col: torch.Tensor  # (nnz,) int32
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return self.val.shape[0]


@dataclasses.dataclass(frozen=True, eq=False)
class JDS:
    """Jagged diagonal storage (paper Fig. 5).

    Rows sorted by decreasing nnz; jagged diagonal j holds the j-th nonzero
    of every row that has one. jd_ptr[j] offsets into val/col_ind.
    """

    perm: torch.Tensor     # (rows,) int32 — perm[i] = original row of sorted row i
    nzcnt: torch.Tensor    # (rows,) int32 — nnz of sorted row i
    jd_ptr: torch.Tensor   # (max_nnz+1,) int32
    val: torch.Tensor      # (nnz,)
    col_ind: torch.Tensor  # (nnz,) int32
    shape: Tuple[int, int]


@dataclasses.dataclass(frozen=True, eq=False)
class WindowedELL:
    """ELL compacted by slab and column window (SELL-32 per window).

    Rows go in slabs of ``SLAB`` (32).  A slab stores only the column
    windows its rows touch, each as one segment, in window order:

    * ``seg_ptr`` (n_slabs+1,) int32: slab b owns segments
      ``seg_ptr[b] .. seg_ptr[b+1]-1``;
    * ``seg_window`` (n_seg,) int32: the window of each segment;
    * ``seg_offset`` (n_seg+1,) int64: the first slot of each segment, and
      the end of the last;
    * ``val`` / ``col`` (n_slots,): a segment's slots are column-major, slot
      k of the slab's row i at ``seg_offset[s] + k*SLAB + i``.  Its width
      (slots a row) is the largest number of entries any of its rows has in
      the window, rounded up to ``SEG_WIDTH``.  ``col`` holds the window-local id
      ``col % window`` as uint16 (a window is at most 65,536 ids).  Unused
      slots have val=0, col=0.

    ``perm`` is the row sort of the ELL it came from, if any.  The kernel
    follows the segments unchecked, so a layout whose segments would read
    past its slots or its columns is refused when it is built.
    """

    val: torch.Tensor         # (n_slots,)
    col: torch.Tensor         # (n_slots,) uint16
    seg_ptr: torch.Tensor     # (n_slabs+1,) int32
    seg_window: torch.Tensor  # (n_seg,) int32
    seg_offset: torch.Tensor  # (n_seg+1,) int64
    window: int
    shape: Tuple[int, int]
    perm: Optional[torch.Tensor] = None  # (rows,) int32

    def __post_init__(self):
        rows, cols = self.shape
        n_seg, n_slots = self.n_segments, self.val.shape[0]
        if (self.val.dim() != 1 or self.col.shape != self.val.shape
                or self.seg_window.dim() != 1
                or self.seg_ptr.shape != (-(-rows // SLAB) + 1,)
                or self.seg_offset.shape != (n_seg + 1,)):
            raise ValueError(
                f"a layout of {rows} rows needs 1-D val and col of one "
                f"length, {-(-rows // SLAB) + 1} seg_ptr entries and "
                f"{n_seg + 1} seg_offset entries; got val "
                f"{tuple(self.val.shape)}, col {tuple(self.col.shape)}, "
                f"seg_ptr {tuple(self.seg_ptr.shape)}, seg_offset "
                f"{tuple(self.seg_offset.shape)}")
        if self.val.device.type == "meta":
            return                     # shapes only: there are no values
        ptr, off, win = (self.seg_ptr.long(), self.seg_offset.long(),
                         self.seg_window.long())
        size = torch.diff(off)
        # a segment's columns end at its window's end or at the matrix's
        limit = torch.clamp(cols - win * self.window, max=self.window)
        ok = bool(torch.stack([
            ptr[0] == 0, ptr[-1] == n_seg, (torch.diff(ptr) >= 0).all(),
            off[0] == 0, off[-1] == n_slots, (size >= 0).all(),
            (size % SLAB == 0).all(), ((win >= 0) & (limit > 0)).all()]).all())
        if ok:
            seg = torch.repeat_interleave(
                torch.arange(n_seg, device=off.device), size,
                output_size=n_slots)
            ok = bool((self.col.long() < limit[seg]).all())
        if not ok:
            raise ValueError(
                "layout segments out of bounds: need seg_ptr to grow from 0 "
                f"to {n_seg}, seg_offset to grow from 0 to {n_slots} in "
                f"whole slabs of {SLAB} slots, windows in [0, "
                f"{self.n_windows}) and local ids within the window and "
                f"the {cols} columns")

    @property
    def n_windows(self) -> int:
        return max(1, -(-self.shape[1] // self.window))

    @property
    def n_slabs(self) -> int:
        return self.seg_ptr.shape[0] - 1

    @property
    def n_segments(self) -> int:
        return self.seg_window.shape[0]


@dataclasses.dataclass(frozen=True, eq=False)
class BCSR:
    """Block CSR with dense (bm, bk) tiles.

    blocks:       (nblocks, bm, bk) dense tiles
    block_col:    (nblocks,) int32 — block-column index of each tile
    block_rowptr: (block_rows+1,) int32 — CSR structure over tile rows
    ``shape`` is padded to whole tiles.
    """

    blocks: torch.Tensor
    block_col: torch.Tensor
    block_rowptr: torch.Tensor
    shape: Tuple[int, int]
    block_shape: Tuple[int, int]

    @property
    def nblocks(self) -> int:
        return self.blocks.shape[0]

    @property
    def block_rows(self) -> int:
        return self.shape[0] // self.block_shape[0]

    @functools.cached_property
    def all_block_rows_nonempty(self) -> bool:
        """True when every block row owns at least one stored tile; read
        once per packed matrix (one host sync), not per call."""
        return bool(torch.all(torch.diff(self.block_rowptr) > 0))

    def todense(self) -> torch.Tensor:
        bm, bk = self.block_shape
        rows, cols = self.shape
        out = torch.zeros((rows // bm, bm, cols // bk, bk),
                          dtype=self.blocks.dtype, device=self.blocks.device)
        brow = torch.repeat_interleave(
            torch.arange(self.block_rows, device=self.blocks.device),
            torch.diff(self.block_rowptr).long(), output_size=self.nblocks)
        out.permute(0, 2, 1, 3)[brow, self.block_col.long()] = self.blocks
        return out.reshape(rows, cols)


@dataclasses.dataclass(frozen=True, eq=False)
class PackedBCSR:
    """BCSR's (bm, bk) tile structure with only each tile's entries stored.

    ``block_col``, ``block_rowptr``, ``shape`` and ``block_shape`` are
    BCSR's, tile for tile (an empty block row keeps its explicit tile, now
    with no entries).  In place of dense tiles:

    * ``val`` (nnz,): the entries, tile after tile, within a tile by
      (row i, column k) — f32 or bf16;
    * ``local`` (nnz,) uint16: each entry's ``i * bk + k`` (so
      ``bm * bk`` is at most 65,536);
    * ``tile_ptr`` (nblocks+1,) int64: tile t's entries are
      ``tile_ptr[t] .. tile_ptr[t+1]-1``;
    * ``row_start`` (nblocks, bm) uint16: row i of tile t starts at entry
      ``tile_ptr[t] + row_start[t, i]`` and ends where row i+1 starts (the
      last row at ``tile_ptr[t+1]``);
    * ``col_mask`` (nblocks, ceil(bk/32)) int32: bit k % 32 of word k // 32
      is set when tile t has an entry in column k (the operand rows the
      kernel stages for the tile).

    The kernel follows the offsets unchecked, so a layout whose offsets
    would read past its entries or whose ids leave their tile or row is
    refused when it is built.
    """

    val: torch.Tensor           # (nnz,)
    local: torch.Tensor         # (nnz,) uint16
    tile_ptr: torch.Tensor      # (nblocks+1,) int64
    row_start: torch.Tensor     # (nblocks, bm) uint16
    col_mask: torch.Tensor      # (nblocks, ceil(bk/32)) int32
    block_col: torch.Tensor     # (nblocks,) int32
    block_rowptr: torch.Tensor  # (block_rows+1,) int32
    shape: Tuple[int, int]
    block_shape: Tuple[int, int]

    def __post_init__(self):
        bm, bk = self.block_shape
        rows, cols = self.shape
        if bm * bk > 1 << 16 or bm <= 0 or bk <= 0:
            raise ValueError(f"tiles of {bm}x{bk} do not take 16-bit local "
                             f"ids (bm * bk must be in [1, 65536])")
        if rows % bm or cols % bk:
            raise ValueError(f"shape {self.shape} is not a multiple of "
                             f"{self.block_shape}")
        nb, nnz = self.block_col.shape[0], self.val.shape[0]
        if (self.val.dim() != 1 or self.local.shape != self.val.shape
                or self.local.dtype != torch.uint16
                or self.block_col.dim() != 1
                or self.tile_ptr.shape != (nb + 1,)
                or self.row_start.shape != (nb, bm)
                or self.row_start.dtype != torch.uint16
                or self.col_mask.shape != (nb, -(-bk // 32))
                or self.block_rowptr.shape != (rows // bm + 1,)):
            raise ValueError(
                f"a packed BCSR of {nb} tiles of {bm}x{bk} over {rows} rows "
                f"needs 1-D val and uint16 local of one length, {nb + 1} "
                f"tile_ptr entries, uint16 row_start ({nb}, {bm}), col_mask "
                f"({nb}, {-(-bk // 32)}) and {rows // bm + 1} block_rowptr "
                f"entries; got val "
                f"{tuple(self.val.shape)}, local {tuple(self.local.shape)} "
                f"{self.local.dtype}, tile_ptr {tuple(self.tile_ptr.shape)}, "
                f"row_start {tuple(self.row_start.shape)} "
                f"{self.row_start.dtype}, col_mask "
                f"{tuple(self.col_mask.shape)}, block_rowptr "
                f"{tuple(self.block_rowptr.shape)}")
        if self.val.device.type == "meta":
            return                     # shapes only: there are no values
        ptr, brp = self.tile_ptr.long(), self.block_rowptr.long()
        size = torch.diff(ptr)
        checks = [ptr[0] == 0, ptr[-1] == nnz, (size >= 0).all(),
                  brp[0] == 0, brp[-1] == nb, (torch.diff(brp) >= 0).all()]
        if nb:
            bc = self.block_col.long()
            checks.append(((bc >= 0) & (bc < cols // bk)).all())
        ok = bool(torch.stack(checks).all())
        if ok and nnz:
            tile = torch.repeat_interleave(
                torch.arange(nb, device=ptr.device), size, output_size=nnz)
            loc = self.local.long()
            row = torch.div(loc, bk, rounding_mode="floor").clamp(max=bm)
            # ids strictly increase within a tile, and each row's entries
            # sit where row_start says
            same = tile[1:] == tile[:-1]
            counts = torch.zeros(nb * (bm + 1), dtype=torch.int64,
                                 device=ptr.device).index_add_(
                0, tile * (bm + 1) + row, torch.ones_like(row)
            ).view(nb, bm + 1)[:, :bm]
            start = torch.cumsum(counts, 1) - counts
            ok = bool(torch.stack([
                (row < bm).all(), (loc[1:] > loc[:-1])[same].all(),
                (self.row_start.long() == start).all()]).all())
            ok = ok and torch.equal(self.col_mask,
                                    _col_mask(tile, loc % bk, nb, bk))
        elif ok:
            ok = bool((self.row_start.long() == 0).all()
                      and (self.col_mask == 0).all())
        if not ok:
            raise ValueError(
                "packed tiles out of bounds: need tile_ptr to grow from 0 "
                f"to {nnz}, block_rowptr from 0 to {nb}, block columns "
                f"within the {cols // bk} of the shape, local ids below "
                f"{bm * bk} and increasing within a tile, row_start to "
                "count each tile's entries of the rows before, and col_mask "
                "to mark each tile's columns")

    @property
    def nblocks(self) -> int:
        return self.block_col.shape[0]

    @property
    def block_rows(self) -> int:
        return self.shape[0] // self.block_shape[0]

    @property
    def nnz(self) -> int:
        return self.val.shape[0]

    def todense(self) -> torch.Tensor:
        bm, bk = self.block_shape
        dev = self.val.device
        tile = torch.repeat_interleave(
            torch.arange(self.nblocks, device=dev),
            torch.diff(self.tile_ptr), output_size=self.nnz)
        brow = torch.repeat_interleave(
            torch.arange(self.block_rows, device=dev),
            torch.diff(self.block_rowptr).long(), output_size=self.nblocks)
        loc = self.local.long()
        row = brow[tile] * bm + torch.div(loc, bk, rounding_mode="floor")
        col = self.block_col.long()[tile] * bk + loc % bk
        out = torch.zeros(self.shape, dtype=self.val.dtype, device=dev)
        out[row, col] = self.val
        return out


@dataclasses.dataclass(frozen=True, eq=False)
class ELL:
    """Row-padded format (JDS rows padded to a lane-aligned width).

    val/col (rows, width); padding entries have val=0, col=0 (valid gather).
    ``perm`` is the JDS-style row sort (identity if unsorted) so that rows
    next to each other have similar nnz and padding waste is bounded.
    """

    val: torch.Tensor   # (rows, width)
    col: torch.Tensor   # (rows, width) int32
    perm: torch.Tensor  # (rows,) int32
    shape: Tuple[int, int]

    @property
    def width(self) -> int:
        return self.val.shape[1]


# ---------------------------------------------------------------------------
# Host-side constructors (numpy; byte-identical to the JAX package).
# ---------------------------------------------------------------------------

def csr_from_dense(dense, device="cpu") -> CSR:
    d = _np(dense)
    rows, cols = d.shape
    r, c = np.nonzero(d)           # row-major order == CSR order
    counts = np.bincount(r, minlength=rows)
    row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return CSR(val=_t(d[r, c], device), col_ind=_t(c.astype(np.int32), device),
               row_ptr=_t(row_ptr, device), shape=(rows, cols))


def coo_from_dense(dense, device="cpu") -> COO:
    d = _np(dense)
    r, c = np.nonzero(d)
    return COO(val=_t(d[r, c], device), row=_t(r.astype(np.int32), device),
               col=_t(c.astype(np.int32), device), shape=tuple(d.shape))


def _sorted_rows(row_ptr: np.ndarray, sort_rows: bool = True):
    """JDS row order: (perm, nnz of each sorted row)."""
    nnz_per_row = np.diff(row_ptr)
    if sort_rows:
        perm = np.argsort(-nnz_per_row, kind="stable").astype(np.int32)
    else:
        perm = np.arange(nnz_per_row.shape[0], dtype=np.int32)
    return perm, nnz_per_row[perm]


def _row_slots(counts: np.ndarray):
    """For rows with ``counts`` entries each: (row id, slot within row) of
    every entry, row-major."""
    rows = np.repeat(np.arange(counts.shape[0]), counts)
    ends = np.cumsum(counts)
    slots = np.arange(ends[-1] if counts.size else 0) - np.repeat(
        ends - counts, counts)
    return rows, slots


def jds_from_csr(csr: CSR) -> JDS:
    """Paper Fig. 5: sort rows by decreasing nnz, store jagged diagonals."""
    row_ptr = _np(csr.row_ptr)
    val = _np(csr.val)
    col = _np(csr.col_ind)
    perm, nzcnt = _sorted_rows(row_ptr)
    nzcnt = nzcnt.astype(np.int32)
    max_nnz = int(nzcnt[0]) if csr.rows else 0
    ri, k = _row_slots(nzcnt)
    order = np.lexsort((ri, k))     # diagonal-major, sorted row within
    p = row_ptr[perm[ri]] + k
    per_diag = np.bincount(k, minlength=max_nnz)[:max_nnz]
    jd_ptr = np.concatenate([[0], np.cumsum(per_diag)]).astype(np.int32)
    dev = csr.val.device
    return JDS(perm=_t(perm, dev), nzcnt=_t(nzcnt, dev), jd_ptr=_t(jd_ptr, dev),
               val=_t(val[p[order]].astype(val.dtype), dev),
               col_ind=_t(col[p[order]].astype(np.int32), dev),
               shape=csr.shape)


def ell_from_csr(csr: CSR, width: Optional[int] = None, sort_rows: bool = True,
                 lane: int = 8) -> ELL:
    """Pad each row to ``width`` (lane-aligned).

    ``sort_rows`` applies the JDS permutation so padding waste between
    neighbouring rows is bounded; the permutation is part of the format (a
    marshaled invariant).  Vectorised: one scatter of all stored entries
    instead of a loop over rows, with the same output bytes.
    """
    row_ptr = _np(csr.row_ptr)
    valv = _np(csr.val)
    colv = _np(csr.col_ind)
    rows = csr.rows
    perm, counts = _sorted_rows(row_ptr, sort_rows)
    nnz_per_row = np.diff(row_ptr)
    w = int(nnz_per_row.max()) if rows and nnz_per_row.size else 0
    if width is not None:
        w = max(w, width)
    w = max(lane, ((w + lane - 1) // lane) * lane)
    val = np.zeros((rows, w), dtype=valv.dtype)
    col = np.zeros((rows, w), dtype=np.int32)
    ri, k = _row_slots(counts)
    src = row_ptr[:-1][perm][ri] + k
    val[ri, k] = valv[src]
    col[ri, k] = colv[src]
    dev = csr.val.device
    return ELL(val=_t(val, dev), col=_t(col, dev), perm=_t(perm, dev),
               shape=csr.shape)


def bcsr_from_dense(dense, block_shape=(8, 128), device=None) -> BCSR:
    """Tile a dense matrix and keep only its nonzero tiles, in block-row
    then block-column order; an empty block row keeps one explicit zero
    tile at block column 0, as the reference does.  Vectorised over the
    tiles, with the reference's bytes."""
    d = _np(dense)
    if device is None:
        device = dense.device if isinstance(dense, torch.Tensor) else "cpu"
    bm, bk = block_shape
    rows, cols = d.shape
    if rows % bm or cols % bk:
        raise ValueError(f"shape {d.shape} is not a multiple of {block_shape}")
    tiles = d.reshape(rows // bm, bm, cols // bk, bk).swapaxes(1, 2)
    keep = np.any(tiles != 0, axis=(2, 3))             # (block rows, cols)
    empty = ~keep.any(axis=1)
    keep[empty, 0] = True
    br, bc = np.nonzero(keep)                          # row-major order
    blocks = tiles[br, bc]
    blocks[empty[br]] = 0                              # the explicit zeros
    block_rowptr = np.concatenate(
        [[0], np.cumsum(keep.sum(axis=1))]).astype(np.int32)
    return BCSR(blocks=_t(blocks, device),
                block_col=_t(bc.astype(np.int32), device),
                block_rowptr=_t(block_rowptr, device),
                shape=(rows, cols), block_shape=(bm, bk))


def _col_mask(tile: torch.Tensor, k: torch.Tensor, nblocks: int,
              bk: int) -> torch.Tensor:
    """(nblocks, ceil(bk/32)) int32: bit k % 32 of word k // 32 of row t
    is set when some entry of tile t is in column k."""
    words = -(-bk // 32)
    used = torch.unique(tile * bk + k)     # each (tile, column) once
    t = torch.div(used, bk, rounding_mode="floor")
    k = used - t * bk
    bits = torch.zeros(nblocks * words, dtype=torch.int64, device=k.device)
    bits.index_add_(0, t * words + torch.div(k, 32, rounding_mode="floor"),
                    torch.bitwise_left_shift(torch.ones_like(k), k % 32))
    # the 32 bits as int32, two's complement
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    return bits.to(torch.int32).view(nblocks, words)


def packed_bcsr(val: torch.Tensor, tile: torch.Tensor, local: torch.Tensor,
                block_col: torch.Tensor, block_rowptr: torch.Tensor,
                shape: Tuple[int, int],
                block_shape: Tuple[int, int]) -> PackedBCSR:
    """A :class:`PackedBCSR` from its entries, already in (tile, local id)
    order: ``tile`` the index of each entry's tile, ``local`` its
    ``i * bk + k``; the offsets are counted from them."""
    bm, bk = block_shape
    nb = block_col.shape[0]
    dev = val.device
    tile, local = tile.long(), local.long()
    tile_ptr = torch.zeros(nb + 1, dtype=torch.int64, device=dev)
    tile_ptr[1:] = torch.cumsum(torch.bincount(tile, minlength=nb), 0)
    counts = torch.bincount(
        tile * bm + torch.div(local, bk, rounding_mode="floor"),
        minlength=nb * bm).view(nb, bm)
    row_start = torch.cumsum(counts, 1) - counts
    return PackedBCSR(val=val, local=local.to(torch.int32).to(torch.uint16),
                      tile_ptr=tile_ptr,
                      row_start=row_start.to(torch.int32).to(torch.uint16),
                      col_mask=_col_mask(tile, local % bk, nb, bk),
                      block_col=block_col, block_rowptr=block_rowptr,
                      shape=tuple(shape), block_shape=(bm, bk))


def pack_bcsr(bcsr: BCSR) -> PackedBCSR:
    """The dense tiles' nonzero entries, tile for tile: the packed layout
    of a BCSR that a caller already holds."""
    bm, bk = bcsr.block_shape
    t, i, k = torch.nonzero(bcsr.blocks, as_tuple=True)   # (t, i, k) order
    return packed_bcsr(bcsr.blocks[t, i, k], t, i * bk + k, bcsr.block_col,
                       bcsr.block_rowptr, bcsr.shape, bcsr.block_shape)


def ell_windows(val: torch.Tensor, col: torch.Tensor, cols: int,
                window: int = WINDOW,
                perm: Optional[torch.Tensor] = None) -> WindowedELL:
    """Compact ELL slots by (slab, column window), on the tensors' device.

    One stable sort of the stored slots by (slab, window, row) places every
    slot: its segment is its (slab, window) run and its slot within the row
    its rank in its (row, window) run.  Nothing of size (rows, n_windows,
    width) is built.  Slots with val == 0 (the ELL padding, and any stored
    zero) are dropped: they add nothing to a row's sum, and keeping the
    padding would pile it all into window 0."""
    if not 0 < window <= 1 << 16:
        raise ValueError(f"window must be in (0, 65536] for 16-bit local "
                         f"ids, got {window}")
    dev = val.device
    rows = val.shape[0]
    n_windows = max(1, -(-cols // window))
    n_slabs = -(-rows // SLAB)
    r, j = torch.nonzero(val, as_tuple=True)
    c = col[r, j].long()
    key = (r // SLAB * n_windows + torch.div(c, window, rounding_mode="floor")
           ) * SLAB + r % SLAB
    key, order = torch.sort(key, stable=True)
    n = key.shape[0]
    idx = torch.arange(n, device=dev)
    new_run = torch.ones(n, dtype=torch.bool, device=dev)
    new_run[1:] = key[1:] != key[:-1]
    k = idx - idx[new_run][torch.cumsum(new_run, 0) - 1]
    seg_key = torch.div(key, SLAB, rounding_mode="floor")
    new_seg = torch.ones(n, dtype=torch.bool, device=dev)
    new_seg[1:] = seg_key[1:] != seg_key[:-1]
    seg = torch.cumsum(new_seg, 0) - 1
    starts = seg_key[new_seg]
    n_seg = starts.shape[0]
    width = torch.zeros(n_seg, dtype=torch.int64, device=dev).scatter_reduce_(
        0, seg, k + 1, "amax")
    seg_offset = torch.zeros(n_seg + 1, dtype=torch.int64, device=dev)
    seg_offset[1:] = torch.cumsum((width + SEG_WIDTH - 1) // SEG_WIDTH * SEG_WIDTH * SLAB, 0)
    seg_ptr = torch.zeros(n_slabs + 1, dtype=torch.int32, device=dev)
    seg_ptr[1:] = torch.cumsum(torch.bincount(
        torch.div(starts, n_windows, rounding_mode="floor"),
        minlength=n_slabs), 0)
    pos = seg_offset[seg] + k * SLAB + key % SLAB
    n_slots = int(seg_offset[-1])
    val_out = torch.zeros(n_slots, dtype=val.dtype, device=dev)
    val_out[pos] = val[r, j][order]
    col_out = torch.zeros(n_slots, dtype=torch.int32, device=dev)
    col_out[pos] = (c[order] % window).to(torch.int32)
    return WindowedELL(val=val_out, col=col_out.to(torch.uint16),
                       seg_ptr=seg_ptr,
                       seg_window=(starts % n_windows).to(torch.int32),
                       seg_offset=seg_offset, window=window,
                       shape=(rows, cols), perm=perm)


# ---------------------------------------------------------------------------
# Numpy interchange: the state carried between the two packages.
# ---------------------------------------------------------------------------

_CONTAINERS = {cls.__name__: cls
               for cls in (CSR, COO, ELL, JDS, BCSR, PackedBCSR)}
_TUPLES = ("shape", "block_shape")


def from_numpy(src: Any, kind: Optional[str] = None, device="cpu"):
    """Build this package's container from any object that carries the
    same field names as numpy-convertible arrays plus ``shape``: the JAX
    package's container of the same class name, or a mapping of arrays.
    ``kind`` names the container; it defaults to ``type(src).__name__``."""
    kind = kind or type(src).__name__
    cls = _CONTAINERS.get(kind)
    if cls is None:
        raise TypeError(f"no container {kind!r} (have {sorted(_CONTAINERS)})")
    get = src.__getitem__ if isinstance(src, Mapping) else \
        functools.partial(getattr, src)
    kw: Dict[str, Any] = {}
    for f in dataclasses.fields(cls):
        if f.name in _TUPLES:
            kw[f.name] = tuple(int(s) for s in get(f.name))
        else:
            kw[f.name] = _t(np.asarray(get(f.name)), device)
    return cls(**kw)


def to_numpy(c) -> Dict[str, Any]:
    """The container's arrays as numpy, plus its ``shape``."""
    out: Dict[str, Any] = {}
    for f in dataclasses.fields(c):
        v = getattr(c, f.name)
        out[f.name] = tuple(v) if f.name in _TUPLES else _np(v)
    return out
