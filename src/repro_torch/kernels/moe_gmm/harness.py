"""LiLAC HARNESS declaration for the CUDA grouped-matmul MoE kernel.

Counterpart of ``repro.kernels.moe_gmm.harness`` (the ``pallas.gmm``
block), declared for ``cuda``.  The reference's ``tune``, ``constraint``
and ``vjp`` clauses are left out until the port has an autotuner and a
backward pass: the kernel runs at tm = 128, and its CTA covers 128 x 128
outputs.
"""
from __future__ import annotations

from repro_torch.core.spec import harness
from repro_torch.kernels.moe_gmm import ops as gmm_ops


@harness("""
HARNESS cuda.gmm implements moe_ffn
  default_for cuda;
""")
def moe_gmm_cuda(b, ctx):
    return gmm_ops.moe_ffn(b["x"], b["gate"], b["idx"], b["wg"], b["wu"],
                           b["wd"])
