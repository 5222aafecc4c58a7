"""LiLAC HARNESS declarations for the CUDA ELL SpMV kernels.

Counterpart of ``repro.kernels.spmv_ell.harness`` (the ``pallas.ell``
blocks), declared for ``cuda``.  "Add a backend" is a HARNESS block plus a
kernel body: marshaling for the CSR/COO entry point is generated from the
``ell_pack128`` clause, whose value is the slab-compacted column-window
layout of the matrix's lane-128 ELL (``ops.pack_ell128``).  The two
blocks run different K1 bodies: the direct ELL/JDS block gets the user's
arrays on every call and cannot amortise a repack, so it runs the direct
one-warp-a-row body on them, through the custom op
``lilac_torch::spmv_ell`` (jit-safe: trace mode puts it in the rewritten
graph); the CSR/COO block runs K1's staged body (the vector in shared
memory, window by window) on the marshaled layout, or K2 for a vector
past ``RESIDENT_VEC_LIMIT`` (host only).  ``fuse epilogue``: the kernels
apply a detected ``(+bias) -> relu|silu`` before their single store — for
the CSR/COO entry too, since the marshaled row permutation is a full
permutation and the kernel's store un-permutes it.

``tune rows_per_slab``: the rows of a slab of K1's direct body.  The body
runs one CTA an SM; slab b goes to CTA b mod the grid, whose half-warps
take its rows in turn.  Each row is summed by one half-warp in a fixed
order, so every value computes the same bits.  Only 32 is declared: 8,
which deals the rows out more evenly, timed the same at NPB-C and at its
first 4,096 rows (``chip_smoke.py``'s ``slab_variants`` times 32, 8, 64
and 128), and larger slabs only unbalance the CTAs.  The staged body and K2 take no launch
parameter, so the CSR/COO block declares none: the autotuner chooses
between harnesses there.  The reference's ``dimsem`` clauses are
Mosaic's and have no counterpart.
"""
from __future__ import annotations

from repro_torch.core.rewrite import apply_epilogue, fused_bias
from repro_torch.core.spec import harness
from repro_torch.kernels.spmv_ell import ops as ell_ops


@harness("""
HARNESS cuda.ell implements spmv_ell, spmv_jds
  formats ELL, JDS;
  default_for cuda;
  fuse epilogue;
  tune rows_per_slab in {32};
""")
def spmv_ell_cuda(b, ctx, *, rows_per_slab):
    """Direct ELL/JDS match -> K1's direct body on the user's arrays."""
    op = ell_ops.spmv_ell_op
    perm = b.get("perm")
    bias = fused_bias(b, ctx)
    if perm is None and ell_ops._fusable(bias, b["val"].shape[0]):
        # pure ELL: the epilogue fuses before the kernel's only store
        return op(b["val"], b["col_ind"], b["vector"], bias, None, None,
                  ctx.epilogue, rows_per_slab)
    # JDS: a user's perm need not name every row, and the detected bias
    # lives in output space, so the epilogue applies after the scatter (as
    # it does for a bias the kernel cannot index per row)
    out = op(b["val"], b["col_ind"], b["vector"], None,
             None if perm is None else perm.int(),
             None if perm is None else b["rows"], None, rows_per_slab)
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
                                   bias=fused_bias(b, ctx))
