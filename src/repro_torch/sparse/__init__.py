"""Sparse matrix substrate: formats, conversions, reference ops.

Counterpart of ``repro.sparse`` (CSR, COO, ELL, JDS, BCSR), plus the
kernels' own layouts (WindowedELL, PackedBCSR);
``from_numpy`` / ``to_numpy`` carry a matrix between the
two packages as numpy arrays.
"""
from repro_torch.sparse.formats import (
    BCSR,
    CSR,
    COO,
    ELL,
    JDS,
    PackedBCSR,
    WindowedELL,
    bcsr_from_dense,
    coo_from_dense,
    csr_from_dense,
    ell_from_csr,
    ell_windows,
    from_numpy,
    jds_from_csr,
    pack_bcsr,
    to_numpy,
)
from repro_torch.sparse.ops import (bcsr_spmm_ref, spmv_coo_ref, spmv_csr_ref,
                                    spmv_ell_ref)
from repro_torch.sparse.random import random_csr, random_spd_csr, stencil27_csr

__all__ = [
    "CSR", "COO", "ELL", "JDS", "WindowedELL", "BCSR", "PackedBCSR",
    "csr_from_dense", "coo_from_dense", "ell_from_csr", "ell_windows",
    "jds_from_csr", "bcsr_from_dense", "pack_bcsr", "from_numpy", "to_numpy",
    "spmv_csr_ref", "spmv_coo_ref", "spmv_ell_ref", "bcsr_spmm_ref",
    "random_csr", "random_spd_csr", "stencil27_csr",
]
