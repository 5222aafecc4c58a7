"""Dry-run of every (arch x shape x mesh) cell: the memory and FLOP
accounting of one rank's step on the production meshes.

Counterpart of ``repro.launch.dryrun``'s ``lower_cell`` / ``analyze_cell``
pair.  It runs on no device and starts no process group of 256 or 512
ranks: it is accounting, not a measurement.

  * bytes: ``argument_size_in_bytes`` (parameters, optimizer state, batch,
    decode cache) and ``output_size_in_bytes`` (new parameters and
    optimizer state and three metrics; logits and caches) from the
    shardings' local shapes at the mesh's axis sizes
    (``train.train_step``'s sharding trees).  Logits, which the
    reference's serve steps leave to the compiler, are counted
    replicated.
  * FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over one rank's
    step (train: loss, gradients, AdamW; prefill; decode) run on
    ``FakeTensorMode`` tensors of the rank's local shapes, under a fake
    process group of the mesh's size (torch's ``fake`` backend: rank 0
    of 256 or 512, every collective a no-op): 2·M·N·K a product, as the
    reference's HLO walker counts.  ``lilac_torch::moe_ffn`` (K4) has a
    FLOP formula of its own (``register_moe_ffn_flops``); the reference
    counts its ``pallas_call`` as 0, so compare it with the reference on
    the grouped or naive MoE.  A recurrent mixer's scan over time
    (``layers.chunked_scan``) runs two steps and counts the others as
    their multiples, their backward as twice their forward (exact for
    products whose operands all take gradients).  The mixers that run
    replicated over the model axis (RWKV-6's time and channel mix,
    Mamba) are counted in full on every rank, and named with their
    forward FLOPs (``replicated_mixer_forward_flops``: every model rank
    repeats them); so is attention where the model axis does not divide
    the heads.
  * collectives: the payload bytes and calls of ``launch.collectives``
    by kind, as the rank's step issues them.
  * peak memory: not given (see ROADMAP).

    python -m repro_torch.launch.dryrun --arch olmoe-1b-7b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all [--mesh both] [--jobs-dir DIR]

``--all`` runs each cell in a subprocess and writes its JSON to the jobs
directory; a cell the architecture does not run gives the reference's
skip reason.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
from typing import Any, Dict, Optional

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import (SHAPES, all_archs, get_arch, shape_skips,
                                 smoke_config)
from repro_torch.launch.mesh import mesh_rules
from repro_torch.models import build_model
from repro_torch.models import spec as S
from repro_torch.train import optim as O
from repro_torch.train import train_step as TS

# gradient-accumulation factors of the train shape (the reference's: each
# divides global_batch / batch shards)
TRAIN_MICROBATCHES = {
    "rwkv6-1.6b": 2,
    "internvl2-2b": 2,
    "granite-moe-3b-a800m": 2,
    "olmoe-1b-7b": 2,
    "granite-8b": 2,
    "mistral-large-123b": 8,
    "granite-34b": 4,
    "olmo-1b": 1,
    "jamba-v0.1-52b": 8,
    "hubert-xlarge": 2,
}

MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}


def register_moe_ffn_flops() -> None:
    """A FLOP formula for ``lilac_torch::moe_ffn``: its three grouped
    products over the padded rows Tp (the static worst case K4 computes),
    2·Tp·D·F each."""
    from torch.utils import flop_counter
    from repro_torch.kernels.moe_gmm import ops  # noqa: F401  (the op)

    op = torch.ops.lilac_torch.moe_ffn
    if op in flop_counter.flop_registry:
        return

    @flop_counter.register_flop_formula(op)
    def _moe_ffn_flops(x_shape, gate_shape, idx_shape, wg_shape, wu_shape,
                       wd_shape, tm, *args, out_shape=None, **kwargs):
        T, K = idx_shape
        E, D, F = wg_shape
        tp = math.ceil(T * K / tm) * tm + (E - 1) * tm
        return 3 * 2 * tp * D * F


def _dtype(name):
    return getattr(torch, name) if isinstance(name, str) else name


def cell_config(arch: str, shape_name: str,
                arch_overrides: Optional[Dict[str, Any]] = None,
                smoke: bool = False):
    cfg = smoke_config(get_arch(arch)) if smoke else get_arch(arch)
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        cfg = cfg.replace(microbatches=TRAIN_MICROBATCHES.get(cfg.name, 1))
    if arch_overrides:
        cfg = cfg.replace(**{k: _dtype(v) if k.endswith("dtype") else v
                             for k, v in arch_overrides.items()})
    return cfg, shape


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               opt_overrides: Optional[dict] = None,
               arch_overrides: Optional[dict] = None,
               axis_sizes: Optional[Dict[str, int]] = None,
               shape=None, smoke: bool = False) -> dict:
    """The cell's model, its step's inputs as ``meta`` tensors and their
    sharding trees (``axis_sizes``, ``shape`` and ``smoke`` replace the
    production mesh, the named shape and the published config for a
    reduced cell)."""
    cfg, named = cell_config(arch, shape_name, arch_overrides, smoke)
    shape = shape or named
    skip = shape_skips(cfg, shape)
    if skip:
        return {"status": "skip", "reason": skip}
    sizes = dict(axis_sizes or MESHES["multi" if multi_pod else "single"])
    rules = mesh_rules("pod" in sizes)
    cfg = cfg.replace(spmd_constraints=True,
                      mesh_axis_sizes=tuple(sizes.items()))
    model = build_model(cfg)
    params = model.abstract_params()
    pshard = TS.param_shardings(model, sizes, rules)
    inputs = model.input_specs(shape)
    cell = {"status": "lowered", "cfg": cfg, "shape": shape, "model": model,
            "sizes": sizes, "rules": rules, "args": {}, "outputs": {}}
    if shape.kind == "train":
        opt_cfg = O.AdamWConfig(**(opt_overrides or {}))
        opt = O.adamw_init(opt_cfg, params)
        oshard = TS.opt_state_shardings(model, opt_cfg, sizes, rules)
        cell["opt_cfg"] = opt_cfg
        cell["args"] = {"params": (params, pshard), "opt": (opt, oshard),
                        "batch": (inputs, TS.batch_shardings(model, shape,
                                                             sizes, rules))}
        metrics = {k: torch.empty((), device="meta")
                   for k in ("grad_norm", "lr", "loss")}
        cell["outputs"] = {"params": (params, pshard), "opt": (opt, oshard),
                           "metrics": (metrics, _replicated(metrics, sizes))}
    elif shape.kind == "prefill":
        cell["args"] = {"params": (params, pshard),
                        "batch": (inputs, TS.batch_shardings(model, shape,
                                                             sizes, rules))}
        logits = torch.empty((shape.global_batch, cfg.vocab),
                             device="meta")
        cell["outputs"] = {
            "logits": (logits, _replicated(logits, sizes)),
            "cache": (model.prefill_cache_specs(shape),
                      TS.prefill_cache_shardings(model, shape, sizes,
                                                 rules))}
    else:
        bsh = TS.batch_shardings(model, shape, sizes, rules)
        cell["args"] = {"params": (params, pshard),
                        "cache": (inputs["cache"], bsh["cache"]),
                        "tokens": (inputs["tokens"], bsh["tokens"]),
                        "pos": (inputs["pos"], bsh["pos"])}
        logits = torch.empty((shape.global_batch, cfg.vocab),
                             device="meta")
        cell["outputs"] = {"logits": (logits, _replicated(logits, sizes)),
                           "cache": (inputs["cache"], bsh["cache"])}
    return cell


def _replicated(tree, sizes):
    return pytree.tree_map(
        lambda t: S.NamedSharding(sizes, (None,) * t.dim()), tree)


def _leaves(tree, shard):
    """(tensor, sharding) pairs of a tree and its sharding tree."""
    return zip(pytree.tree_leaves(tree),
               pytree.tree_structure(tree).flatten_up_to(shard))


def local_bytes(tree, shard, sizes) -> int:
    """Bytes a rank holds of ``tree`` at its sharding tree."""
    return sum(math.prod(S.local_shape(t.shape, sh.spec, sizes))
               * t.element_size() for t, sh in _leaves(tree, shard))


# ---------------------------------------------------------------------------
# One rank's step on fake tensors
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(sizes: Dict[str, int]):
    """A fake process group of the mesh's size (this process is rank 0)
    and the mesh over it; the group is destroyed on exit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n = math.prod(sizes.values())
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield init_device_mesh("cpu", tuple(sizes.values()),
                               mesh_dim_names=tuple(sizes))
    finally:
        dist.destroy_process_group()


class _Accounting:
    """The dry-run's additions to the FLOP counter: a scan's unrun steps
    and the FLOPs of the mixers that run replicated over the model
    axis."""

    def __init__(self, counter, sizes):
        self.counter, self.sizes = counter, sizes
        self.scan_flops = 0
        self.replicated: Dict[str, int] = {}

    def total(self) -> int:
        return self.counter.get_total_flops() + self.scan_flops

    def scan(self, step, init, xs, chunk: int = 128):
        """Two steps run (the second's output depends on the first's
        carry, so every parameter of the step takes a gradient), the
        others counted as their multiples: forward, plus twice that for
        their backward in a first forward with gradients (a remat
        replay, inside backward, adds its forward only)."""
        steps = xs[0].shape[0]
        run = min(steps, 2)
        first = torch._C._current_graph_task_id() == -1
        grad = first and torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad
            for a in (init, *xs))
        before = self.total()
        carry, ys = init, []
        for t in range(run):
            carry, y = step(carry, tuple(a[t] for a in xs))
            ys.append(y)
        per = (self.total() - before) / run
        self.scan_flops += int(per * (steps - run) * (3 if grad else 1))
        ys = torch.stack(ys)
        return carry, torch.cat([ys, ys[-1:].expand(
            (steps - run,) + tuple(ys.shape[1:]))])

    def named(self, name: str, fn):
        """``fn`` with its forward FLOPs counted under ``name`` (a remat
        replay inside backward is not counted again)."""
        def run(*args, **kwargs):
            before = self.total()
            out = fn(*args, **kwargs)
            if torch._C._current_graph_task_id() == -1:
                self.replicated[name] = self.replicated.get(name, 0) + \
                    self.total() - before
            return out
        return run


@contextlib.contextmanager
def _patched(acc: "_Accounting", cfg):
    """The scan accounting in the recurrent mixers, and the replicated
    mixers named."""
    from repro_torch.models import layers as L
    from repro_torch.models import mamba as M
    from repro_torch.models import rwkv as R

    saved = [(L, "chunked_scan"), (M, "chunked_scan"), (R, "chunked_scan"),
             (R, "timemix"), (R, "channelmix"), (M, "mamba_block"),
             (L, "attention_block_mesh"), (L, "attention_decode_mesh")]
    old = [getattr(m, n) for m, n in saved]
    for mod in (L, M, R):
        mod.chunked_scan = acc.scan
    R.timemix = acc.named("rwkv6 time mix", old[3])
    R.channelmix = acc.named("rwkv6 channel mix", old[4])
    M.mamba_block = acc.named("mamba mixer", old[5])
    if cfg.n_heads % acc.sizes.get("model", 1):
        L.attention_block_mesh = acc.named("attention (heads unsharded)",
                                           old[6])
        L.attention_decode_mesh = acc.named("attention (heads unsharded)",
                                            old[7])
    try:
        yield
    finally:
        for (m, n), f in zip(saved, old):
            setattr(m, n, f)


def rank_step(cell) -> dict:
    """FLOPs and collectives of rank 0's step of a lowered cell."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import collectives as C

    register_moe_ffn_flops()
    sizes, model, shape = cell["sizes"], cell["model"], cell["shape"]
    with fake_world(sizes) as mesh, FakeTensorMode(), C.use_mesh(mesh):
        def local(tree, shard):
            return pytree.tree_unflatten(
                [torch.zeros(S.local_shape(t.shape, sh.spec, sizes),
                             dtype=t.dtype)
                 for t, sh in _leaves(tree, shard)],
                pytree.tree_structure(tree))

        args = {k: local(*v) for k, v in cell["args"].items()}
        C.reset_stats()
        with FlopCounterMode(display=False) as counter:
            acc = _Accounting(counter, sizes)
            with _patched(acc, cell["cfg"]):
                if shape.kind == "train":
                    step = TS.make_train_step(model, cell["opt_cfg"])
                    step(args["params"], args["opt"], args["batch"])
                elif shape.kind == "prefill":
                    with torch.no_grad():
                        model.prefill(args["params"], args["batch"])
                else:
                    specs = S.tree_map(lambda sh: sh.spec,
                                       cell["args"]["cache"][1])
                    with torch.no_grad():
                        model.decode(args["params"], args["cache"],
                                     args["tokens"], args["pos"], specs)
        return {"flops": acc.total(), "scan_flops": acc.scan_flops,
                "replicated_mixer_forward_flops": acc.replicated,
                "collectives": {k: dict(v) for k, v in C.STATS.items()}}


def analyze_cell(arch: str, shape_name: str, multi_pod: bool,
                 opt_overrides: Optional[dict] = None,
                 arch_overrides: Optional[dict] = None,
                 axis_sizes: Optional[Dict[str, int]] = None,
                 shape=None, smoke: bool = False) -> dict:
    t0 = time.time()
    cell = lower_cell(arch, shape_name, multi_pod, opt_overrides,
                      arch_overrides, axis_sizes, shape, smoke)
    mesh_name = "multi" if multi_pod else "single"
    if cell["status"] == "skip":
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skip", "reason": cell["reason"]}
    sizes, model = cell["sizes"], cell["model"]
    step = rank_step(cell)
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "status": "ok",
        "accounting": "memory and FLOPs counted from shapes on fake "
                      "tensors; no device ran",
        "seconds": round(time.time() - t0, 1),
        "n_devices": math.prod(sizes.values()),
        "axis_sizes": sizes,
        "params_total": model.param_count(),
        "params_active": model.active_param_count(),
        "flops": step["flops"],
        "scan_flops": step["scan_flops"],
        "replicated_mixer_forward_flops":
            step["replicated_mixer_forward_flops"],
        "collectives": step["collectives"],
        "memory": {
            "argument_size_in_bytes": sum(
                local_bytes(t, sh, sizes)
                for t, sh in cell["args"].values()),
            "output_size_in_bytes": sum(
                local_bytes(t, sh, sizes)
                for t, sh in cell["outputs"].values()),
            "arguments_by_kind": {k: local_bytes(t, sh, sizes)
                                  for k, (t, sh) in cell["args"].items()},
        },
    }


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def run_one(args) -> int:
    result = analyze_cell(args.arch, args.shape, args.mesh == "multi",
                          arch_overrides=json.loads(args.overrides or "{}"))
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0 if result["status"] in ("ok", "skip") else 1


def run_all(args) -> int:
    os.makedirs(args.jobs_dir, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    failures = 0
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for arch in all_archs():
        for shape in SHAPES:
            for mesh in meshes:
                name = f"{arch}__{shape}__{mesh}".replace("/", "_")
                path = os.path.join(args.jobs_dir, name + ".json")
                if os.path.exists(path) and not args.force:
                    print(f"[cached] {name}")
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--mesh", mesh,
                       "--out", path]
                if args.overrides:
                    cmd += ["--overrides", args.overrides]
                print(f"[run] {name}", flush=True)
                t0 = time.time()
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=args.timeout,
                                      env={**os.environ, "PYTHONPATH": src})
                dt = time.time() - t0
                if proc.returncode != 0:
                    failures += 1
                    err = (proc.stderr or "")[-2000:]
                    with open(path, "w") as f:
                        json.dump({"arch": arch, "shape": shape,
                                   "mesh": mesh, "status": "fail",
                                   "error": err}, f, indent=1)
                    print(f"[FAIL {dt:.0f}s] {name}\n{err}", flush=True)
                else:
                    print(f"[ok {dt:.0f}s] {name}", flush=True)
    return 1 if failures else 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--overrides", default=None,
                    help='JSON ArchConfig overrides, e.g. {"moe_impl":"naive"}')
    ap.add_argument("--jobs-dir", default="experiments/dryrun_torch")
    ap.add_argument("--timeout", type=int, default=1800)
    args = ap.parse_args()
    if args.all:
        sys.exit(run_all(args))
    if not (args.arch and args.shape and args.mesh in ("single", "multi")):
        ap.error("give --arch, --shape and --mesh single|multi, or --all")
    sys.exit(run_one(args))


if __name__ == "__main__":
    main()
