"""Quickstart: the paper's Fig. 1 experience.

An application author writes a naive CSR SpMV in plain PyTorch.  The LiLAC
pass detects it in the traced graph, replaces it with a harness, and the
program runs on the harness's kernel — with no change to the application
code.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
"""
import torch

from repro_torch import lilac
from repro_torch.core import what_lang
from repro_torch.examples.common import (compiled, naive_spmv, parser,
                                         seconds)
from repro_torch.sparse.random import random_csr

ROWS, COLS = 4096, 4096


def main():
    args = parser(__doc__, policy="cuda.ell").parse_args()
    device = torch.device(args.device)
    print("LiLAC-What specification (paper Fig. 2):")
    print(what_lang.BUILTINS["spmv_csr"])
    print()
    csr = random_csr(ROWS, COLS, density=0.002, seed=0, device=device)
    gen = torch.Generator().manual_seed(1)
    vec = torch.randn(COLS, generator=gen).to(device)
    operands = (csr.val, csr.col_ind, csr.row_ptr, vec)

    # detection + rewrite; host mode runs the marshaling harnesses
    spmv = lilac.compile(naive_spmv, mode="host", policy=args.policy,
                         device=device)
    out = spmv(*operands)
    print("detection:", spmv.last_report.summary())
    print("harness:", [name for _, name in spmv.last_selections])
    ref = naive_spmv(*operands)
    print("max |lilac - naive| =", float((out - ref).abs().max()))

    # measure: the naive SpMV compiled (steady state) against lilac's
    naive = compiled(naive_spmv, device)
    naive(*operands)
    reps = 50
    _, t_naive = seconds(lambda: [naive(*operands) for _ in range(reps)],
                         device)
    _, t_lilac = seconds(lambda: [spmv(*operands) for _ in range(reps)],
                         device)
    print(f"naive   : {t_naive / reps * 1e6:9.1f} us/call "
          f"(torch.compile, {naive.backend})")
    print(f"lilac   : {t_lilac / reps * 1e6:9.1f} us/call")
    print(f"speedup : {t_naive / t_lilac:.2f}x (marshaled once: "
          f"{spmv.cache.stats.misses} repack, {spmv.cache.stats.hits} hits; "
          f"baked plan: {spmv.plan_info()['plan_hits']} hits)")


if __name__ == "__main__":
    main()
