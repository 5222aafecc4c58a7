"""LiLAC HARNESS declarations for the CUDA BCSR SpMM kernel.

Counterpart of ``repro.kernels.bsr_spmm.harness`` (the two ``pallas.bcsr``
blocks), declared for ``cuda``.  The 128x128 tiling repacks are marshal
clauses (``bcsr_pack128`` / ``bcsr_pack_mm128``) whose planned path is the
direct CSR -> BCSR128x128 edge, which builds the packed tiles of
``formats.PackedBCSR`` (each tile's entries only, ~6 B an entry) from the
CSR's entries, with no dense tile.  As ``default_for cuda`` the SpMM block
repacks any matrix this way, as the reference tiles any matrix on the TPU;
at NAS CG class C's 36 M entries that is ~1.37 M tiles in ~0.61 GB (the
tiles' row starts weigh more than their ~26 entries each).  The
reference's ``tune``, ``constraint`` and ``vjp`` clauses
are left out until the port has an autotuner and a backward pass.
``fuse epilogue``: the kernel applies a detected ``(+bias) -> relu|silu``
before its single store.
"""
from __future__ import annotations

from repro_torch.core.spec import harness
from repro_torch.kernels.bsr_spmm import ops as bsr_ops


@harness("""
HARNESS cuda.bcsr implements spmv_csr, spmv_coo
  platforms cuda;
  formats CSR, COO;
  host_only;
  marshal bcsr = bcsr_pack128(a, colidx, rowstr|rowidx)
      from csr_binding to BCSR128x128;
  fuse epilogue;
""")
def spmv_bcsr_cuda_host(b, ctx, *, bcsr):
    """The vector is the kernel's one-column dense operand: the kernel's
    N = 1 width masks the other columns, where the reference tiles the
    vector to 128 columns.  The SpMV output is (rows,), so only a bias of
    that length rides the kernel as a row bias."""
    bias = b.get("bias")
    kind = "row" if bias is not None and bias.dim() == 1 \
        and bias.shape[0] == b["rows"] else None
    out = bsr_ops.bsr_spmm(bcsr, b["iv"][:, None], epilogue=ctx.epilogue,
                           bias=bias, bias_kind=kind, out_rows=b["rows"])
    return out[:, 0]


@harness("""
HARNESS cuda.bcsr implements spmm_csr
  formats CSR, COO;
  host_only;
  default_for cuda;
  marshal bcsr = bcsr_pack_mm128(a, colidx, rowstr|rowidx)
      from csr_binding_mm to BCSR128x128;
  fuse epilogue;
""")
def spmm_bcsr_cuda_host(b, ctx, *, bcsr):
    """The detected bias adds to the (rows, N) product by broadcasting, so
    a bias of shape (N,) is a column bias and one of (rows, 1) a row bias,
    whatever rows and N are."""
    bias = b.get("bias")
    kind = None
    if bias is not None and tuple(bias.shape) == (b["dense"].shape[1],):
        kind = "col"
    elif bias is not None and tuple(bias.shape) == (b["rows"], 1):
        bias, kind = bias.reshape(-1), "row"
    return bsr_ops.bsr_spmm(bcsr, b["dense"], epilogue=ctx.epilogue,
                            bias=bias, bias_kind=kind, out_rows=b["rows"])
