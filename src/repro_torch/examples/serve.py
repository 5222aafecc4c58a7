"""Serving-tier client: drive the continuous-batching engine
(``repro_torch.serve``) over a synthetic workload on baked plans.

The engine owns the whole flow — bucketed plan prewarming, per-request
prefill and cache install, per-step admit/evict, batched decode with
per-slot positions — so the client is: build engine, submit workload,
read metrics.  Counterpart of the root ``examples/serve.py``.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve
          [--arch olmoe-1b-7b] [--requests 8] [--mode continuous|static]
          [--device cuda|cpu]
"""
import argparse
import json

from repro_torch.serve import (BucketPolicy, ServeConfig, SyntheticWorkload,
                               build_engine)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="olmoe-1b-7b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--mode", default="continuous",
                    choices=["continuous", "static"])
    ap.add_argument("--tokens", type=int, default=12,
                    help="max new tokens per request")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    # admit_deadline_s: a full queue is retried with bounded backoff
    # (Scheduler.try_admit) before rejecting; deadline_s evicts requests
    # that overstay their latency budget instead of pinning a slot
    cfg = ServeConfig(buckets=BucketPolicy(batch=(1, 2, 4), seq=(32, 64)),
                      mode=args.mode, admit_deadline_s=0.05,
                      deadline_s=120.0)
    eng = build_engine(args.arch, smoke=True, config=cfg, device=args.device)
    pw = eng.metrics.prewarm
    print(f"prewarm: {pw['baked']}/{pw['n_signatures']} bucket plans baked "
          f"({pw['plan_cache_hits']} rehydrated from the plan cache)")

    wl = SyntheticWorkload(n_requests=args.requests,
                           vocab=eng.model.cfg.vocab, prompt_grid=(4, 8, 12),
                           new_tokens=(2, args.tokens), rate_rps=0.0, seed=0)
    pairs = wl.requests()
    snap = eng.run(pairs)

    print(f"mode={args.mode} finished={snap['requests']['finished']} "
          f"steps={snap['steps']} occupancy={snap['batch_occupancy']:.2f}")
    print(f"ttft p50={snap['ttft_s']['p50'] * 1e3:.1f} ms  "
          f"decode-step p50={snap['decode_step_s']['p50'] * 1e3:.2f} ms  "
          f"bucket hits/misses={snap['buckets']['hits']}"
          f"/{snap['buckets']['misses']}")
    res = snap["resilience"]
    print(f"resilience: decode_faults={res['decode_faults']} "
          f"fault_evictions={res['fault_evictions']} "
          f"admission_retries={res['admission_retries']}")
    print(f"selections: {[n for _, n in eng._decode.last_selections]}")
    first = pairs[0][1]
    print("first request tokens:", json.dumps(first.tokens[:10]))
    return snap


if __name__ == "__main__":
    main()
