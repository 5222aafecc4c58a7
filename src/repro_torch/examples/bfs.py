"""BFS (paper §5) as a boolean-semiring SpMV: the frontier changes every
step but the matrix does not, so marshaling still amortizes.

Run:  PYTHONPATH=src python -m repro_torch.examples.bfs [--nodes 4096]
"""
import torch

from repro_torch import lilac
from repro_torch.examples.common import (compiled, naive_spmv, parser,
                                         seconds)
from repro_torch.sparse.random import random_graph_csr


def graph(n: int, device):
    """The reference's graph (``random_graph_csr``, about 8 links a node)
    and its 0/1 edge values: BFS's boolean semiring."""
    g = random_graph_csr(n, avg_degree=8, seed=0, device=device)
    return g, (g.val > 0).float()


def main():
    ap = parser(__doc__, policy="autotune")
    ap.add_argument("--nodes", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=12)
    args = ap.parse_args()
    device = torch.device(args.device)
    n = args.nodes
    g, val01 = graph(n, device)

    def bfs(spmv):
        frontier = torch.zeros(n, device=device)
        frontier[0] = 1.0
        visited = frontier
        for _ in range(args.steps):
            nxt = spmv(val01, g.col_ind, g.row_ptr, frontier)
            frontier = ((nxt > 0) & (visited == 0)).float()
            visited = torch.maximum(visited, frontier)
        return visited

    naive = compiled(naive_spmv, device)
    bfs(naive)
    v0, t_naive = seconds(lambda: bfs(naive), device)
    spmv = lilac.compile(naive_spmv, mode="host", policy=args.policy,
                         device=device)
    bfs(spmv)
    v1, t_lilac = seconds(lambda: bfs(spmv), device)
    print(f"nodes={n} nnz={g.nnz} via "
          f"{[name for _, name in spmv.last_selections]}")
    print(f"reached {int(v0.sum())} nodes (naive) / {int(v1.sum())} (lilac)")
    print(f"naive (torch.compile, {naive.backend}) : {t_naive:.3f}s   "
          f"lilac : {t_lilac:.3f}s   "
          f"speedup {t_naive / t_lilac:.2f}x")


if __name__ == "__main__":
    main()
