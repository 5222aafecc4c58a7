"""End-to-end training driver: train a reduced OLMoE-family MoE LM with the
LiLAC pass live inside the layer (``moe_impl="lilac"``: the naive one-hot
MoE of each sequence is detected in the traced graph and rewritten to the
MoE harness, ``cuda.gmm`` on the card, whose gradient is its ``vjp``
clause's body).

The default is laptop-scale; ``--full`` trains a ~100M-parameter config.

    PYTHONPATH=src python -m repro_torch.examples.train_e2e [--steps 60] \\
        [--full] [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import get_arch
from repro_torch.core import jit
from repro_torch.models import build_model
from repro_torch.train.data import SyntheticLM
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.optim import AdamWConfig


def make_config(full: bool, moe_impl: str):
    base = get_arch("olmoe-1b-7b")
    if full:
        return base.replace(n_layers=8, d_model=512, n_heads=8, n_kv_heads=8,
                            d_ff=512, vocab=16384, moe_experts=16, moe_topk=4,
                            moe_impl=moe_impl, kv_chunk=256, remat=False,
                            param_dtype=torch.float32)
    return base.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                        d_ff=128, vocab=1024, moe_experts=8, moe_topk=2,
                        moe_impl=moe_impl, kv_chunk=64, remat=False,
                        param_dtype=torch.float32)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--moe-impl", default="lilac",
                    choices=["naive", "lilac", "grouped"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = make_config(args.full, args.moe_impl)
    model = build_model(cfg)
    print(f"arch family={cfg.family} layers={cfg.n_layers} "
          f"d_model={cfg.d_model} experts={cfg.moe_experts} "
          f"params={model.param_count()/1e6:.1f}M "
          f"(active {model.active_param_count()/1e6:.1f}M) "
          f"moe_impl={cfg.moe_impl}")
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq,
                       global_batch=args.batch)
    opt = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    loop = LoopConfig(steps=args.steps, ckpt_every=max(args.steps // 3, 1),
                      log_every=10, ckpt_dir=args.ckpt_dir)
    res = train_loop(model, opt, loop, data.batch_at, device=args.device,
                     backend=jit.backend_for(args.device))
    h = res["history"]
    print(f"loss: {h[0]:.4f} -> {h[-1]:.4f} over {len(h)} steps "
          f"({'DECREASED' if h[-1] < h[0] else 'no improvement'})")
    print(f"stragglers observed: {res['straggler'].slow_steps}")
    if res["compiled"]:
        print(f"compiled step: {res['compiled']}")


if __name__ == "__main__":
    main()
