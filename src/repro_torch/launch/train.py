"""Training launcher on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \\
        [--steps N] [--smoke] [--layers L] [--data data.bin] \\
        [--ckpt-dir ckpts] [--compress-grads] [--moe-impl lilac] \\
        [--device cpu]

Counterpart of ``repro.launch.train``; ``--smoke`` takes the reduced
config, ``--layers`` cuts the depth.  The mesh flags come with the
distributed slice.
"""
import argparse

from repro_torch.configs import get_arch, smoke_config
from repro_torch.models import build_model
from repro_torch.train.data import MemmapCorpus, SyntheticLM
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.optim import AdamWConfig


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-scale)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--data", default=None, help="token .bin (int32)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--moe-impl", default=None,
                    choices=[None, "naive", "lilac", "grouped"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    if args.moe_impl:
        cfg = cfg.replace(moe_impl=args.moe_impl)
    model = build_model(cfg)
    print(f"{cfg.name}: {model.param_count()/1e6:.1f}M params "
          f"({model.active_param_count()/1e6:.1f}M active), {args.device}")

    if args.data:
        data = MemmapCorpus(args.data, args.seq, args.batch, seed=args.seed)
    else:
        data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq,
                           global_batch=args.batch, seed=args.seed)
    opt = AdamWConfig(lr=args.lr, total_steps=args.steps,
                      warmup_steps=max(args.steps // 10, 1),
                      compress_grads=args.compress_grads)
    loop = LoopConfig(steps=args.steps, ckpt_every=max(args.steps // 4, 1),
                      log_every=10, ckpt_dir=args.ckpt_dir)
    res = train_loop(model, opt, loop, data.batch_at, device=args.device,
                     seed=args.seed)
    h = res["history"]
    if not h:               # resumed from a checkpoint of the last step
        print(f"final: nothing to run, resumed at step {res['start_step']} "
              f"of {args.steps}")
        return
    print(f"final: loss {h[0]:.4f} -> {h[-1]:.4f}; "
          f"stragglers={res['straggler'].slow_steps}")


if __name__ == "__main__":
    main()
