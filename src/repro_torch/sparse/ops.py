"""Reference sparse ops in plain torch.

Counterpart of ``repro.sparse.ops``: the semantic oracles for the kernels
and for the plain ``torch.*`` harness bodies.
"""
from __future__ import annotations

import torch

from repro_torch.sparse.formats import BCSR, COO, CSR, ELL


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
                       device=prod.device).index_add_(0, row, prod)


def spmv_coo_ref(coo: COO, vec: torch.Tensor) -> torch.Tensor:
    prod = coo.val * vec[coo.col]
    return torch.zeros(coo.shape[0], dtype=prod.dtype,
                       device=prod.device).index_add_(0, coo.row, prod)


def spmv_ell_ref(ell: ELL, vec: torch.Tensor) -> torch.Tensor:
    """Padded-row SpMV; un-permutes at the end."""
    acc = torch.sum(ell.val * vec[ell.col], dim=1)
    out = torch.zeros(ell.shape[0], dtype=acc.dtype, device=acc.device)
    out[ell.perm.long()] = acc
    return out


def bcsr_spmm_ref(bcsr: BCSR, dense: torch.Tensor) -> torch.Tensor:
    """(rows, cols) block-sparse @ (cols, n) dense -> (rows, n)."""
    bm, bk = bcsr.block_shape
    rows, cols = bcsr.shape
    n = dense.shape[1]
    brow = row_ids_from_row_ptr(bcsr.block_rowptr, bcsr.nblocks).long()
    rhs = dense.reshape(cols // bk, bk, n)[bcsr.block_col.long()]
    prod = torch.einsum("kij,kjn->kin", bcsr.blocks, rhs)
    out = torch.zeros((bcsr.block_rows, bm, n), dtype=prod.dtype,
                      device=prod.device).index_add_(0, brow, prod)
    return out.reshape(rows, n)

