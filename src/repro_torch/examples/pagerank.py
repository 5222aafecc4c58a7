"""PageRank (paper §5): many SpMV iterations over one matrix — the data
plane amortizes the format repack (paper Fig. 18).

Run:  PYTHONPATH=src python -m repro_torch.examples.pagerank [--nodes 4096]
"""
import torch

from repro_torch import lilac
from repro_torch.examples.common import naive_spmv, parser, seconds
from repro_torch.sparse.random import random_csr


def links(n: int, device):
    """A random graph of ``n`` pages, about 16 links each, as CSR, and its
    column-stochastic link weights: each page splits its rank among the
    pages it links to, so an iterate keeps its sum.  Without the split the
    iterate grows by the matrix's spectral radius each step (to ~1e25
    after 40), and the norm of a difference reads as large as that."""
    g = random_csr(n, n, density=16 / n, seed=0, skew=1.0, device=device)
    weight = g.val.abs()
    out = torch.zeros(n, device=device).index_add_(0, g.col_ind.long(),
                                                   weight)
    return g, weight / out[g.col_ind.long()]


def pagerank(spmv, g, val, iters: int, between=None):
    n = g.rows
    x = torch.full((n,), 1.0 / n, device=val.device)
    for _ in range(iters):
        if between is not None:
            between()
        x = 0.85 * spmv(val, g.col_ind, g.row_ptr, x) + 0.15 / n
    return x


def main():
    ap = parser(__doc__, policy="cuda.ell")
    ap.add_argument("--nodes", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=40)
    args = ap.parse_args()
    device = torch.device(args.device)
    g, val = links(args.nodes, device)
    run = lambda spmv, between=None: pagerank(spmv, g, val, args.iters,
                                              between)
    run(naive_spmv)
    x0, t_naive = seconds(lambda: run(naive_spmv), device)
    spmv = lilac.compile(naive_spmv, mode="host", policy=args.policy,
                         device=device)
    run(spmv)                            # warm: the one repack
    x1, t_lilac = seconds(lambda: run(spmv), device)
    # ablation: drop the data plane every iteration = the naive-marshaling
    # variant of Fig. 18
    _, t_repack = seconds(lambda: run(spmv, spmv.cache.clear), device)
    err = float((x1 - x0).abs().max())
    print(f"nodes={args.nodes} nnz={g.nnz} iters={args.iters} via "
          f"{[name for _, name in spmv.last_selections]}")
    print(f"naive            : {t_naive:7.3f}s")
    print(f"lilac (marshal)  : {t_lilac:7.3f}s  speedup "
          f"{t_naive / t_lilac:.2f}x")
    print(f"lilac (no cache) : {t_repack:7.3f}s  marshaling win "
          f"{t_repack / t_lilac:.2f}x")
    print(f"|x_lilac - x_naive|_inf = {err:.2e} "
          f"({err / float(x0.abs().max()):.2e} of |x_naive|_inf; "
          f"sum(x_lilac) = {float(x1.sum()):.6f})")


if __name__ == "__main__":
    main()
