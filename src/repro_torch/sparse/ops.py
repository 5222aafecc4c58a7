"""Reference sparse ops in plain torch.

Counterpart of ``repro.sparse.ops``: the semantic oracles for the kernels
and for the plain ``torch.*`` harness bodies.  They write out of place
(``zeros(...).index_add(...)``), so that they batch under
``torch.func.vmap``.
"""
from __future__ import annotations

import torch

from repro_torch.sparse.formats import BCSR, COO, CSR, ELL, JDS


def row_ids_from_row_ptr(row_ptr: torch.Tensor, nnz: int) -> torch.Tensor:
    """Expand CSR row_ptr to per-nnz row ids."""
    rows = row_ptr.shape[0] - 1
    return torch.repeat_interleave(
        torch.arange(rows, dtype=torch.int32, device=row_ptr.device),
        torch.diff(row_ptr).long(), output_size=nnz)


def spmv_csr_ref(csr: CSR, vec: torch.Tensor) -> torch.Tensor:
    """output[i] = sum_{row_ptr[i] <= j < row_ptr[i+1]} val[j] * vec[col[j]]"""
    row = row_ids_from_row_ptr(csr.row_ptr, csr.nnz)
    prod = csr.val * vec[csr.col_ind]
    return torch.zeros(csr.rows, dtype=prod.dtype,
                       device=prod.device).index_add(0, row, prod)


def spmv_coo_ref(coo: COO, vec: torch.Tensor) -> torch.Tensor:
    prod = coo.val * vec[coo.col]
    return torch.zeros(coo.shape[0], dtype=prod.dtype,
                       device=prod.device).index_add(0, coo.row, prod)


def spmv_ell_ref(ell: ELL, vec: torch.Tensor) -> torch.Tensor:
    """Padded-row SpMV; un-permutes at the end."""
    acc = torch.sum(ell.val * vec[ell.col], dim=1)
    return torch.zeros(ell.shape[0], dtype=acc.dtype,
                       device=acc.device).index_put((ell.perm.long(),), acc)


def spmv_jds_ref(jds: JDS, vec: torch.Tensor) -> torch.Tensor:
    """Paper Fig. 5 semantics:

    output[perm[i]] = sum(0 <= j < nzcnt[i])
        val[jd_ptr[j] + i] * vector[col_ind[jd_ptr[j] + i]]
    """
    rows = jds.shape[0]
    max_nnz = jds.jd_ptr.shape[0] - 1
    acc = torch.zeros(rows, dtype=jds.val.dtype, device=jds.val.device)
    if max_nnz == 0 or jds.val.shape[0] == 0:   # all-zero matrix
        return acc
    i = torch.arange(rows, device=jds.val.device)
    for j in range(max_nnz):
        live = jds.nzcnt > j
        idx = torch.where(live, jds.jd_ptr[j] + i, 0).long()
        acc = acc + torch.where(live, jds.val[idx] * vec[jds.col_ind[idx]],
                                0.0).to(acc.dtype)
    return torch.zeros_like(acc).index_put((jds.perm.long(),), acc)


def bcsr_spmm_ref(bcsr: BCSR, dense: torch.Tensor) -> torch.Tensor:
    """(rows, cols) block-sparse @ (cols, n) dense -> (rows, n)."""
    bm, bk = bcsr.block_shape
    rows, cols = bcsr.shape
    n = dense.shape[1]
    brow = row_ids_from_row_ptr(bcsr.block_rowptr, bcsr.nblocks).long()
    rhs = dense.reshape(cols // bk, bk, n)[bcsr.block_col.long()]
    prod = torch.einsum("kij,kjn->kin", bcsr.blocks, rhs)
    out = torch.zeros((bcsr.block_rows, bm, n), dtype=prod.dtype,
                      device=prod.device).index_add(0, brow, prod)
    return out.reshape(rows, n)


def spmm_csr_ref(csr: CSR, dense: torch.Tensor) -> torch.Tensor:
    """CSR @ dense (cols, n) -> (rows, n)."""
    row = row_ids_from_row_ptr(csr.row_ptr, csr.nnz)
    prod = csr.val[:, None] * dense[csr.col_ind]
    return torch.zeros((csr.rows, dense.shape[1]), dtype=prod.dtype,
                       device=prod.device).index_add(0, row, prod)
