"""Training launcher, on one device or on a (data, model) mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \\
        [--steps N] [--smoke] [--layers L] [--data data.bin] \\
        [--ckpt-dir ckpts] [--compress-grads] [--moe-impl lilac] \\
        [--device cpu] [--mesh-data D --mesh-model M] [--backend gloo]

    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 4 -m repro_torch.launch.train --arch olmoe-1b-7b \\
        --smoke --mesh-data 2 --mesh-model 2 --device cpu --backend gloo

Counterpart of ``repro.launch.train``; ``--smoke`` takes the reduced
config, ``--layers`` cuts the depth; the step runs under
``torch.compile`` (inductor on cuda, aot_eager on cpu).  With a mesh of
more than one rank it runs under torchrun, data x model processes: each
starts the process group (``launch.mesh.init_distributed``: ``--backend``
nccl by default on cuda, gloo on cpu), builds the mesh, and trains its
shards
(``train.loop`` with ``mesh=``); rank 0 prints.  A mesh of 1 is the
one-device path.
"""
import argparse

from repro_torch.configs import get_arch, smoke_config
from repro_torch.launch.mesh import init_distributed, make_host_mesh, mesh_rules
from repro_torch.core import jit
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
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="the process group's (nccl on cuda, gloo on cpu)")
    args = ap.parse_args()

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    if args.moe_impl:
        cfg = cfg.replace(moe_impl=args.moe_impl)
    mesh = rules = None
    say = print
    if args.mesh_data * args.mesh_model > 1:
        backend = args.backend or ("nccl" if args.device == "cuda"
                                   else "gloo")
        if init_distributed(backend, args.device) != 0:
            say = lambda *a, **k: None  # noqa: E731
        mesh = make_host_mesh(args.mesh_data, args.mesh_model)
        rules = mesh_rules(False)
        cfg = cfg.replace(spmd_constraints=True, mesh_axis_sizes=tuple(
            zip(mesh.mesh_dim_names, mesh.shape)))
    model = build_model(cfg)
    say(f"{cfg.name}: {model.param_count()/1e6:.1f}M params "
        f"({model.active_param_count()/1e6:.1f}M active), {args.device}, "
        f"mesh={dict(cfg.mesh_axis_sizes) if mesh else 'single-device'}")

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
                     seed=args.seed, mesh=mesh, rules=rules,
                     backend=jit.backend_for(args.device),
                     emit=say)
    h = res["history"]
    if not h:               # resumed from a checkpoint of the last step
        say(f"final: nothing to run, resumed at step {res['start_step']} "
            f"of {args.steps}")
        return
    say(f"final: loss {h[0]:.4f} -> {h[-1]:.4f}; "
        f"stragglers={res['straggler'].slow_steps}")
    c = res["compiled"]
    if c:
        say(f"compiled step ({c['backend']}): {c['compiles']} graph(s), "
            f"{c['graph_breaks']} graph break(s), first step "
            f"{c['compile_seconds']:.1f}s")


if __name__ == "__main__":
    main()
