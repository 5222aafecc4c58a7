"""NPB-CG analogue: conjugate gradient with a naively written SpMV,
accelerated by the LiLAC pass without touching the solver.

Run:  PYTHONPATH=src python -m repro_torch.examples.cg_solver [--n 20000]
"""
import torch

from repro_torch import lilac
from repro_torch.examples.common import (compiled, naive_spmv, parser,
                                         seconds)
from repro_torch.sparse.random import random_spd_csr


def cg(spmv, csr, b, iters=100, tol=1e-8):
    x = torch.zeros_like(b)
    r = b - spmv(csr.val, csr.col_ind, csr.row_ptr, x)
    p = r
    rs = torch.dot(r, r)
    for i in range(iters):
        ap = spmv(csr.val, csr.col_ind, csr.row_ptr, p)
        alpha = rs / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.dot(r, r)
        if float(rs_new) < tol:
            return x, i + 1
        p = r + (rs_new / rs) * p
        rs = rs_new
    return x, iters


def main():
    ap = parser(__doc__, policy="autotune")
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--row-nnz", type=int, default=15)
    ap.add_argument("--iters", type=int, default=100)
    args = ap.parse_args()
    device = torch.device(args.device)
    csr = random_spd_csr(args.n, args.row_nnz, seed=0, device=device)
    gen = torch.Generator().manual_seed(1)
    b = torch.randn(args.n, generator=gen).to(device)
    fast = lilac.compile(naive_spmv, mode="host", policy=args.policy,
                         device=device)
    naive = compiled(naive_spmv, device)
    naive(csr.val, csr.col_ind, csr.row_ptr, b)         # compiles
    for name, fn in (("naive", naive), ("lilac", fast)):
        (x, k), dt = seconds(lambda: cg(fn, csr, b, iters=args.iters),
                             device)
        resid = float(torch.linalg.vector_norm(
            b - naive_spmv(csr.val, csr.col_ind, csr.row_ptr, x)))
        print(f"{name:6s}: {dt:7.3f}s  {k} iters  residual {resid:.2e}")
    print(f"naive: the SpMV under torch.compile ({naive.backend}, "
          f"{naive.compiles} graph)")
    print(f"lilac ran {[n for _, n in fast.last_selections]}; data plane: "
          f"{fast.cache.stats.misses} repacks (a tuner's warm-up calls "
          f"included), {fast.cache.stats.hits} hits; plan: "
          f"{fast.plan_info()['plan_hits']} hits")


if __name__ == "__main__":
    main()
