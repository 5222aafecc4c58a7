"""PageRank (paper §5): many SpMV iterations over one matrix — the data
plane amortizes the format repack (paper Fig. 18).

Run:  PYTHONPATH=src python -m repro_torch.examples.pagerank [--nodes 4096]
"""
import torch

from repro_torch import lilac
from repro_torch.examples.common import (compiled, naive_spmv, parser,
                                         seconds)
from repro_torch.sparse.random import random_graph_csr


def links(n: int, device):
    """The reference's graph of ``n`` pages, about 16 links each, as CSR
    (``random_graph_csr``), and its link weights: each page splits its
    rank evenly among the pages it links to (the values are
    column-stochastic), so an iterate keeps its sum."""
    g = random_graph_csr(n, avg_degree=16, seed=0, device=device)
    return g, g.val


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
    naive = compiled(naive_spmv, device)
    run(naive)
    x0, t_naive = seconds(lambda: run(naive), device)
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
    print(f"naive (compiled) : {t_naive:7.3f}s  ({naive.backend})")
    print(f"lilac (marshal)  : {t_lilac:7.3f}s  speedup "
          f"{t_naive / t_lilac:.2f}x")
    print(f"lilac (no cache) : {t_repack:7.3f}s  marshaling win "
          f"{t_repack / t_lilac:.2f}x")
    print(f"|x_lilac - x_naive|_inf = {err:.2e} "
          f"({err / float(x0.abs().max()):.2e} of |x_naive|_inf; "
          f"sum(x_lilac) = {float(x1.sum()):.6f})")


if __name__ == "__main__":
    main()
