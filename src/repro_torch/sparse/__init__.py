"""Sparse matrix substrate: formats, conversions, reference ops.

Counterpart of ``repro.sparse`` for the formats the SpMV path uses (CSR,
COO, ELL, JDS); ``from_numpy`` / ``to_numpy`` carry a matrix between the
two packages as numpy arrays.
"""
from repro_torch.sparse.formats import (
    CSR,
    COO,
    ELL,
    JDS,
    WindowedELL,
    coo_from_dense,
    csr_from_dense,
    ell_from_csr,
    ell_windows,
    from_numpy,
    jds_from_csr,
    to_numpy,
)
from repro_torch.sparse.ops import spmv_coo_ref, spmv_csr_ref, spmv_ell_ref
from repro_torch.sparse.random import random_csr, random_spd_csr, stencil27_csr

__all__ = [
    "CSR", "COO", "ELL", "JDS", "WindowedELL",
    "csr_from_dense", "coo_from_dense", "ell_from_csr", "ell_windows",
    "jds_from_csr", "from_numpy", "to_numpy",
    "spmv_csr_ref", "spmv_coo_ref", "spmv_ell_ref",
    "random_csr", "random_spd_csr", "stencil27_csr",
]
