"""Sparse matrix containers (frozen dataclasses of tensors) and host-side
constructors.

Counterpart of ``repro.sparse.formats``.  The storage formats are the
paper's (§3.2 Fig. 4/5):

* CSR  — val / col_ind / row_ptr (paper Fig. 4)
* COO  — val / row / col
* JDS  — perm / nzcnt / jd_ptr / val / col_ind (paper Fig. 5)
* ELL  — row-padded: after the JDS nnz row sort, rows are padded to a
         lane-aligned width so a row is one contiguous slab
* WindowedELL — ELL split by column window, with window-local column ids
         (the layout of the windowed SpMV kernel for long vectors)

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
    """ELL split by column window.

    val/col are ``(rows, n_windows, width)``: slot ``[i, w, k]`` holds the
    k-th stored entry of row i whose column lies in window w, with the
    column id local to the window (``col - w*window``).  Unused slots have
    val=0, col=0.  ``width`` is the largest number of entries any row has
    in one window, rounded up to the lane, not the ELL width.  ``perm`` is
    the row sort of the ELL it came from, if any.
    """

    val: torch.Tensor   # (rows, n_windows, width)
    col: torch.Tensor   # (rows, n_windows, width) int32
    window: int
    shape: Tuple[int, int]
    perm: Optional[torch.Tensor] = None  # (rows,) int32

    @property
    def n_windows(self) -> int:
        return self.val.shape[1]

    @property
    def width(self) -> int:
        return self.val.shape[2]


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


def ell_windows(val: torch.Tensor, col: torch.Tensor, cols: int,
                window: int = WINDOW, lane: int = 8,
                perm: Optional[torch.Tensor] = None) -> WindowedELL:
    """Split ELL slots by column window, on the tensors' device.

    A slot's place in its (row, window) group comes from one stable sort of
    the stored slots by ``row * n_windows + window``, never from a
    ``(rows, width, n_windows)`` one-hot.  Slots with val == 0 (the ELL
    padding, and any stored zero) are dropped: they add nothing to a row's
    sum, and keeping the padding would pile it all into window 0."""
    rows = val.shape[0]
    n_windows = max(1, -(-cols // window))
    r, j = torch.nonzero(val, as_tuple=True)
    c = col[r, j].long()
    key = r * n_windows + torch.div(c, window, rounding_mode="floor")
    key, order = torch.sort(key, stable=True)
    counts = torch.bincount(key, minlength=rows * n_windows)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(key.shape[0], device=val.device) - starts[key]
    most = int(counts.max()) if counts.numel() else 0
    width = max(lane, -(-most // lane) * lane)
    val3 = torch.zeros((rows * n_windows, width), dtype=val.dtype,
                       device=val.device)
    col3 = torch.zeros((rows * n_windows, width), dtype=torch.int32,
                       device=val.device)
    val3[key, pos] = val[r, j][order]
    col3[key, pos] = (c[order] % window).to(torch.int32)
    return WindowedELL(val=val3.view(rows, n_windows, width),
                       col=col3.view(rows, n_windows, width),
                       window=window, shape=(rows, cols), perm=perm)


# ---------------------------------------------------------------------------
# Numpy interchange: the state carried between the two packages.
# ---------------------------------------------------------------------------

_CONTAINERS = {cls.__name__: cls for cls in (CSR, COO, ELL, JDS)}


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
        if f.name == "shape":
            kw["shape"] = tuple(int(s) for s in get("shape"))
        else:
            kw[f.name] = _t(np.asarray(get(f.name)), device)
    return cls(**kw)


def to_numpy(c) -> Dict[str, Any]:
    """The container's arrays as numpy, plus its ``shape``."""
    out: Dict[str, Any] = {}
    for f in dataclasses.fields(c):
        v = getattr(c, f.name)
        out[f.name] = tuple(v) if f.name == "shape" else _np(v)
    return out
