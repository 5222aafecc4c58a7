"""Format conversions used as marshaled invariants (LiLAC-How INPUTs).

Counterpart of ``repro.sparse.convert``.  Each conversion is expensive
relative to one SpMV, so the data plane (``repro_torch.core.marshal``)
memoizes them keyed on the source arrays' fingerprints.
"""
from __future__ import annotations

from repro_torch.sparse.formats import CSR, ELL, JDS, ell_from_csr, jds_from_csr


def csr_to_ell(csr: CSR, **kw) -> ELL:
    return ell_from_csr(csr, **kw)


def csr_to_jds(csr: CSR) -> JDS:
    return jds_from_csr(csr)

