"""Named experiments over the dry-run: (cell, ArchConfig overrides).

Counterpart of ``repro.launch.perf``: each experiment is one dry-run cell
with a config change, and ``run_experiment`` records its accounting
(``launch.dryrun.analyze_cell``: per-device bytes, FLOPs and collective
payload on fake tensors).  The reference re-lowers each cell through XLA
for its roofline deltas; that re-lowering has no counterpart here, the
accounting does.  Nothing here runs on a device.

    PYTHONPATH=src python -m repro_torch.launch.perf --exp olmoe_naive
    PYTHONPATH=src python -m repro_torch.launch.perf --all
"""
import argparse
import json
import os
import subprocess
import sys

# name -> (arch, shape, overrides)
EXPERIMENTS = {
    # ---- cell A: olmoe-1b-7b train_4k (the paper's technique at LM scale)
    "olmoe_baseline": ("olmoe-1b-7b", "train_4k", {}),
    "olmoe_naive": ("olmoe-1b-7b", "train_4k",
                    {"moe_impl": "naive"}),           # paper's -O2 baseline
    "olmoe_cf125": ("olmoe-1b-7b", "train_4k",
                    {"capacity_factor": 1.25}),
    "olmoe_cf100": ("olmoe-1b-7b", "train_4k",
                    {"capacity_factor": 1.0}),
    "olmoe_mb1": ("olmoe-1b-7b", "train_4k", {"microbatches": 1}),
    "olmoe_best": ("olmoe-1b-7b", "train_4k",
                   {"microbatches": 1, "capacity_factor": 1.25,
                    "moe_combine_bf16": True}),
    # ---- cell B: mistral-large-123b train_4k (most collective-bound)
    "mistral_baseline": ("mistral-large-123b", "train_4k", {}),
    "mistral_no_sp": ("mistral-large-123b", "train_4k",
                      {"seq_parallel": False}),       # Megatron-TP baseline
    "mistral_mb4": ("mistral-large-123b", "train_4k", {"microbatches": 4}),
    "mistral_mb16": ("mistral-large-123b", "train_4k", {"microbatches": 16}),
    "mistral_no_remat": ("mistral-large-123b", "train_4k", {"remat": False}),
    # ---- cell C: granite-34b decode_32k (memory-bound decode, MQA)
    "g34_decode_baseline": ("granite-34b", "decode_32k", {}),
    "g34_decode_seqshard": ("granite-34b", "decode_32k",
                            {"decode_cache_seq_shard": True}),
    "g34_decode_f8cache": ("granite-34b", "decode_32k",
                           {"cache_dtype": "float8_e4m3fn"}),
    "g34_decode_f8_seqshard": ("granite-34b", "decode_32k",
                               {"cache_dtype": "float8_e4m3fn",
                                "decode_cache_seq_shard": True}),
}


def run_experiment(name: str, out_dir: str = "experiments/perf_torch") -> dict:
    from repro_torch.launch.dryrun import analyze_cell
    arch, shape, overrides = EXPERIMENTS[name]
    res = analyze_cell(arch, shape, multi_pod=False,
                       arch_overrides=overrides)
    res["experiment"] = name
    res["overrides"] = {k: str(v) for k, v in overrides.items()}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name + ".json"), "w") as f:
        json.dump(res, f, indent=1)
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--exp", default=None, choices=list(EXPERIMENTS))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out-dir", default="experiments/perf_torch")
    args = ap.parse_args()
    if args.all:
        # one subprocess an experiment
        src = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        fails = 0
        for name in EXPERIMENTS:
            path = os.path.join(args.out_dir, name + ".json")
            if os.path.exists(path) and not args.force:
                print(f"[cached] {name}")
                continue
            print(f"[run] {name}", flush=True)
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.perf", "--exp",
                 name, "--out-dir", args.out_dir],
                env={**os.environ, "PYTHONPATH": src},
                capture_output=True, text=True, timeout=2400)
            if proc.returncode != 0:
                fails += 1
                print(f"[FAIL] {name}\n{(proc.stderr or '')[-1200:]}")
                os.makedirs(args.out_dir, exist_ok=True)
                with open(path, "w") as f:
                    json.dump({"experiment": name, "status": "fail",
                               "error": (proc.stderr or "")[-1500:]}, f)
            else:
                print(f"[ok] {name}")
        sys.exit(1 if fails else 0)
    if not args.exp:
        ap.error("give --exp NAME or --all")
    res = run_experiment(args.exp, args.out_dir)
    print(json.dumps({k: v for k, v in res.items()
                      if k not in ("collectives", "memory")}))


if __name__ == "__main__":
    main()
