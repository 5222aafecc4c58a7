"""LiLAC HARNESS declaration for the CUDA grouped-matmul MoE kernel.

Counterpart of ``repro.kernels.moe_gmm.harness`` (the ``pallas.gmm``
block), declared for ``cuda``.  The body is the custom op
``lilac_torch::moe_ffn`` (jit-safe: trace mode puts it in the rewritten
graph).

``tune tm``: the row tile, which is the group alignment (128, the first
value, was the constant before).  K4's CTA covers 128 x 128 outputs
whatever tm is (tm = 64 leaves half its rows unused, tm = 256 spans two
CTAs), so tm moves the padding and the tile-expert map, not a row's sum:
every variant computes the same bits, and no shared-memory constraint
depends on it.  The reference's ``fn``/``dk``/``dimsem`` clauses are its
VMEM tiles and Mosaic's.  ``vjp moe_ffn_bwd``: K4 has no backward; the
body recomputes the capacity-bucket dispatch under ``torch.func.vjp`` at
a capacity no expert's load exceeds (the forward drops nothing, so
neither does its gradient), and ``lilac_torch::moe_ffn`` carries it as its autograd
formula (the route trace mode takes).
"""
from __future__ import annotations

from repro_torch.core.spec import harness
from repro_torch.kernels.moe_gmm.ops import moe_ffn_op


@harness("""
HARNESS cuda.gmm implements moe_ffn
  default_for cuda;
  tune tm in {128, 64, 256};
  vjp moe_ffn_bwd(x, gate, wg, wu, wd);
""")
def moe_gmm_cuda(b, ctx, *, tm):
    return moe_ffn_op(b["x"], b["gate"], b["idx"], b["wg"], b["wu"],
                      b["wd"], tm)
