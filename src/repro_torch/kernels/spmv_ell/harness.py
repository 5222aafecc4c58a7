"""LiLAC HARNESS declarations for the CUDA ELL SpMV kernels.

Counterpart of ``repro.kernels.spmv_ell.harness`` (the ``pallas.ell``
blocks), declared for ``cuda``.  "Add a backend" is a HARNESS block plus a
kernel body: marshaling for the CSR/COO entry point is generated from the
``ell_pack128`` clause, whose value is the slab-compacted column-window
layout of the matrix's lane-128 ELL (``ops.pack_ell128``).  The two
blocks run different K1 bodies: the direct ELL/JDS block gets the user's
arrays on every call and cannot amortise a repack, so it runs the direct
one-warp-a-row body on them; the CSR/COO block runs K1's staged body (the
vector in shared memory, window by window) on the marshaled layout, or K2
for a vector past ``RESIDENT_VEC_LIMIT``.  The reference's ``tune``
clauses are left out until the port has an autotuner.  ``fuse
epilogue``: the kernels apply a detected ``(+bias) -> relu|silu`` before
their single store — for the CSR/COO entry too, since the marshaled row
permutation is a full permutation and the kernel's store un-permutes it.
"""
from __future__ import annotations

from repro_torch.core.rewrite import apply_epilogue
from repro_torch.core.spec import harness
from repro_torch.kernels.spmv_ell import ops as ell_ops


@harness("""
HARNESS cuda.ell implements spmv_ell, spmv_jds
  formats ELL, JDS;
  default_for cuda;
  fuse epilogue;
""")
def spmv_ell_cuda(b, ctx):
    """Direct ELL/JDS match -> K1's direct body on the user's arrays."""
    perm = b.get("perm")
    bias = b.get("bias")
    if perm is None:
        # pure ELL: the epilogue fuses before the kernel's only store
        return ell_ops.spmv_ell(b["val"], b["col_ind"], b["vector"],
                                epilogue=ctx.epilogue, bias=bias)
    # JDS: a user's perm need not name every row, and the detected bias
    # lives in output space, so the epilogue applies after the scatter
    out = ell_ops.spmv_ell(b["val"], b["col_ind"], b["vector"],
                           perm=perm.int(), out_rows=b["rows"])
    if ctx.epilogue is not None:
        out = apply_epilogue(out, bias, ctx.epilogue)
    return out


@harness("""
HARNESS cuda.ell implements spmv_csr, spmv_coo
  platforms cuda;
  formats CSR, COO;
  host_only;
  marshal ell = ell_pack128(a, colidx, rowstr|rowidx)
      from csr_binding to ELL128;
  fuse epilogue;
""")
def spmv_ell_cuda_host(b, ctx, *, ell):
    """CSR/COO match -> the marshaled layout (kept on the card) -> K1's
    staged body, or K2 for a long vector."""
    return ell_ops.spmv_ell_packed(ell, b["iv"], epilogue=ctx.epilogue,
                                   bias=b.get("bias"))
