"""Persistent autotuning walkthrough (paper Table 2 / SparseX analogue).

Run this twice:

    PYTHONPATH=src python -m repro_torch.examples.autotune_demo
    PYTHONPATH=src python -m repro_torch.examples.autotune_demo

The first run measures every host-mode candidate on the problem's
signature and persists the winner to the autotune store
(~/.cache/lilac-torch/autotune.json, or $LILAC_TORCH_AUTOTUNE_CACHE).  The
second run — a fresh process — selects the same winner from disk: zero
candidates re-timed.  ``--fresh`` deletes the store first; ``--trace``
also tunes the trace-mode path inside ``torch.compile``, where the winner
is pinned into the rewritten graph when it is built.
"""
import os

import torch

from repro_torch import lilac
from repro_torch.core import REGISTRY
from repro_torch.core.autotune import default_cache_path
from repro_torch.examples.common import (compiled, naive_spmv, parser,
                                         seconds)
from repro_torch.sparse.random import random_graph_csr


def main():
    ap = parser(__doc__, policy="autotune")
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--degree", type=int, default=12)
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--fresh", action="store_true",
                    help="delete the autotune store before running")
    ap.add_argument("--trace", action="store_true",
                    help="also tune the trace-mode path")
    args = ap.parse_args()
    device = torch.device(args.device)
    path = default_cache_path()
    if args.fresh and path.exists():
        os.unlink(path)
        print(f"removed {path}")
    csr = random_graph_csr(args.n, avg_degree=args.degree, seed=0,
                           device=device)
    gen = torch.Generator().manual_seed(1)
    operands = (csr.val, csr.col_ind, csr.row_ptr,
                torch.randn(args.n, generator=gen).to(device))

    tuner = REGISTRY.autotuner
    print(f"autotune store: {tuner.cache.path} "
          f"({'exists' if tuner.cache.path.exists() else 'cold'})")
    spmv = lilac.compile(naive_spmv, mode="host", policy=args.policy,
                         device=device)
    _, first = seconds(lambda: spmv(*operands), device)
    sel = spmv.last_selections[0][1]
    s = tuner.stats
    if s.timing_calls:
        how = f"measured {s.timing_calls} candidate(s)"
        for name, r in tuner.last_report.items():
            print(f"  {name:14s} " + ("raised: eliminated" if r is None else
                  f"steady {r['steady_s'] * 1e3:.4f} ms, repack "
                  f"{r['marshal_s']:.4f} s, amortized "
                  f"{r['amortized_s'] * 1e3:.4f} ms"))
    elif s.fallbacks:
        how = "platform default (tuning disabled or budget exhausted)"
    else:
        how = "warm start — zero candidates re-timed"
    print(f"first call: {first * 1e3:.1f} ms, selected {sel} ({how})")
    _, steady = seconds(lambda: [spmv(*operands)
                                 for _ in range(args.calls)], device)
    print(f"steady state: {steady / args.calls * 1e6:.0f} us/call over "
          f"{args.calls} calls")

    if args.trace:
        # trace mode inside a user's torch.compile, as the reference runs
        # it under jax.jit: the winner is pinned when the graph is built
        opt = lilac.compile(naive_spmv, policy=args.policy, device=device)

        def application(val, col, row_ptr, v):
            return opt(val, col, row_ptr, v)

        jopt = compiled(application, device)
        jopt(*operands)
        print(f"trace mode under torch.compile ({jopt.backend}, "
              f"{jopt.compiles} graph): winner {opt.last_selections[0][1]} "
              f"pinned at lowering")
    print(f"tuner stats: {s.as_dict()}")


if __name__ == "__main__":
    main()
