#!/usr/bin/env python3
"""The bf16 MoE block's call time on one NVIDIA GPU: the compiled MoE
vmapped over the sequences, unplanned and on its batched plan, against
the per-sequence loop on plans, in alternating rounds.

    python3 tools/moe_block_probe.py [--rounds 12] [--calls 20] [--out PATH]

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit.  At ``chip_smoke.py``'s MoE path (OLMoE-1B-7B's expert layer,
2 sequences of 4,096 bf16 tokens, ``cuda.gmm``), each call from a sync to
a sync, router included:

* ``vmap``: ``moe_block(impl="lilac")`` with the MoE compiled with
  ``bake=False``: under ``torch.func.vmap`` each call runs the rewritten
  graph eagerly (3 K4 launches);
* ``vmap_plan``: ``moe_block(impl="lilac")`` as it runs by default, each
  vmapped call a hit on the batched plan the first baked (3 K4
  launches, the program a CUDA graph or eager, as its bake's timing
  chose; ``plan_info()`` printed);
* ``loop``: the router, then the compiled MoE on each sequence (each
  call a baked plan: 6 K4 launches).

Each round times a block of ``--calls`` calls of each variant (the
block's median), the order rotating from round to round; the report
gives each variant's median over the rounds and the rounds' differences
against ``loop``.  It prints the card's name and power limit first;
``--out`` writes the rounds as JSON.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def block_ms(call, calls: int) -> float:
    import torch

    ms = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(ms)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as C
    from repro_torch import lilac
    from repro_torch.configs.olmoe_1b_7b import CONFIG
    from repro_torch.models import layers as L

    print(f"card: {C.smi_line()}")
    device = torch.device("cuda")
    p, x = C.moe_inputs(CONFIG, 0, device)
    topk = CONFIG.moe_topk
    fast = L._lilac_moe_2d("cuda")
    unplanned = lilac.compile(L._moe_naive_2d, platform="cuda", bake=False)

    def block(fn):
        def run():
            L._LILAC_MOE["cuda"] = fn
            try:
                return L.moe_block(p, x, topk=topk, impl="lilac")[0]
            finally:
                L._LILAC_MOE["cuda"] = fast
        return run

    def loop():
        gate, idx, _ = L.moe_router(p, x, topk)
        return torch.stack([fast(x[b], gate[b], idx[b], p["wg"], p["wu"],
                                 p["wd"]) for b in range(x.shape[0])])

    variants = {"vmap": block(unplanned), "vmap_plan": block(fast),
                "loop": loop}
    outs = {name: [fn() for _ in range(5)][-1]         # build, bake, warm
            for name, fn in variants.items()}
    assert torch.equal(outs["vmap"], outs["loop"])
    assert torch.equal(outs["vmap_plan"], outs["loop"])
    plans = [{k: q[k] for k in ("transform", "runs", "eager_reason",
                                "replay_ms", "eager_ms", "hits")}
             for q in fast.plan_info()["plans"]]
    assert any(q["transform"] and q["transform"]["vmap"] for q in plans)
    assert unplanned.plan_info()["baked"] == 0
    print(f"plans of the compiled MoE: {plans}")
    names = list(variants)
    rounds = []
    for i in range(args.rounds):
        order = names[i % 3:] + names[:i % 3]
        rounds.append({n: block_ms(variants[n], args.calls) for n in order})
    med = {n: statistics.median(r[n] for r in rounds) for n in names}
    diffs = {n: [r[n] - r["loop"] for r in rounds] for n in names
             if n != "loop"}
    for n in names:
        line = f"{n}: median {med[n]:.4f} ms"
        if n in diffs:
            line += (f", minus loop by round " + " ".join(
                f"{d:+.4f}" for d in diffs[n]) + f" (median "
                f"{statistics.median(diffs[n]):+.4f} ms, slower in "
                f"{sum(d > 0 for d in diffs[n])} of {len(diffs[n])})")
        print(line)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": C.smi_line(),
                                        "rounds": rounds, "median_ms": med,
                                        "plans": plans}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
