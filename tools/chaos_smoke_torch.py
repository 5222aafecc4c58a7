"""Chaos smoke of the PyTorch/CUDA port: the oracle sweep under faults.

The port's counterpart of ``tools/chaos_smoke.py``'s targeted oracle
sweep: each problem of a small suite is compiled with
``lilac.compile(naive_spmv, mode="host", policy="autotune")`` under the
combined fault spec (kernel raises, NaN outputs, marshal, tune and bake
raises, torn cache writes), called twice (cold and steady state), and the
outputs are held against the uncompiled program.

Gates (exit 1 on any failure):

* ``zero_uncontained_exceptions`` — nothing escapes to the caller;
* ``results_match_oracle`` — every output equals the uncompiled
  program's (atol = rtol = 2e-4);
* ``quarantines_persisted`` — the incidents the faults provoked are on
  disk for the next process.

The fault plan is a pure function of (spec, seed), and every store
(autotune, plans, quarantine) is redirected into a scratch directory, so
``--seed`` alone replays a run; on a gate failure the replay command is
printed.  The benchmark and serving legs of the JAX tool are not ported.

    python tools/chaos_smoke_torch.py [--device cpu|cuda] [--seed N]
                                      [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import traceback
import warnings
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

CHAOS_SPEC = ("kernel_raise:*:0.4,nan_output:*:0.3,marshal_raise:*:0.3,"
              "tune_raise:*:0.4,bake_raise:*:0.4,cache_torn_write:*:0.5")
ATOL = RTOL = 2e-4


def repro_command(seed: int, device: str, out_path=None) -> str:
    """The shell command that replays this run's fault interleaving."""
    cmd = f"CHAOS_SEED={seed} python tools/chaos_smoke_torch.py --device {device}"
    return cmd + (f" --out {out_path}" if out_path else "")


def redirect_stores(scratch: str) -> None:
    """Point every persistent store of the port into ``scratch`` and drop
    the process-wide views, so a chaos run poisons no shared cache."""
    from repro_torch.core.harness import REGISTRY
    from repro_torch.core.plan import reset_shared_plan_caches
    from repro_torch.core.resilience import reset_shared_quarantine

    for name, file in (("AUTOTUNE", "autotune"), ("PLAN", "plans"),
                       ("QUARANTINE", "quarantine")):
        os.environ[f"LILAC_TORCH_{name}_CACHE"] = os.path.join(
            scratch, f"{file}.json")
    REGISTRY.reset_autotuner()
    reset_shared_plan_caches()
    reset_shared_quarantine()


def naive_spmv(val, col, row_ptr, v):
    """The application's textbook CSR SpMV."""
    import torch

    rows = row_ptr.shape[0] - 1
    row = torch.repeat_interleave(torch.arange(rows, device=val.device),
                                  torch.diff(row_ptr), output_size=val.shape[0])
    out = torch.zeros(rows, dtype=val.dtype, device=val.device)
    return out.index_add_(0, row, val * v[col])


def problem_suite(device) -> dict:
    """name -> (CSR, vector): a random symmetric matrix, HPCG's 27-point
    operator on a 16^3 grid, and a 5 % dense block; 4,096, 4,096 and 512
    rows."""
    import numpy as np
    import torch
    from repro_torch.sparse.random import (random_csr, random_spd_csr,
                                           stencil27_csr)

    mats = {"spd_4k": random_spd_csr(4096, 27, seed=0, device=device),
            "hpcg_16": stencil27_csr(16, 16, 16, device=device),
            "dense_block_512": random_csr(512, 512, 0.05, seed=3,
                                          device=device)}
    rng = np.random.default_rng(9)
    return {name: (a, torch.from_numpy(rng.standard_normal(a.shape[1])
                                       .astype(np.float32)).to(device))
            for name, a in mats.items()}


def oracle_sweep(problems: dict, seed: int, device: str,
                 spec: str = CHAOS_SPEC) -> dict:
    """Compile and call every problem twice under ``spec``; hold the
    outputs against the uncompiled program."""
    import torch
    from repro_torch import lilac
    from repro_torch.core import faults

    out = {"problems": {}, "uncontained": [], "mismatches": [],
           "faults_fired": 0, "quarantines": 0, "fallbacks": 0,
           "warnings": 0}
    for name, (a, vec) in problems.items():
        args = (a.val, a.col_ind, a.row_ptr, vec)
        ref = naive_spmv(*args)
        rec = {"fired": 0, "ok": False}
        try:
            with warnings.catch_warnings(record=True) as seen, \
                    faults.inject(spec, seed=seed) as plan:
                warnings.simplefilter("always")
                fast = lilac.compile(naive_spmv, mode="host",
                                     policy="autotune", device=device)
                got = fast(*args)
                got2 = fast(*args)          # the steady state too
            rec["fired"] = len(plan.fired)
            out["faults_fired"] += len(plan.fired)
            out["warnings"] += len(seen)
            info = fast.resilience_info()
            rec["containment"] = info["containment"]
            rec["selections"] = [n for _, n in fast.last_selections]
            out["quarantines"] += info["containment"]["quarantines"]
            out["fallbacks"] += info["containment"]["fallbacks"]
            rec["ok"] = bool(
                torch.allclose(got, ref, atol=ATOL, rtol=RTOL)
                and torch.allclose(got2, ref, atol=ATOL, rtol=RTOL))
            if not rec["ok"]:
                out["mismatches"].append(name)
        except Exception:
            out["uncontained"].append(
                {"problem": name, "traceback": traceback.format_exc()})
        out["problems"][name] = rec
    return out


def gates(sweep: dict) -> dict:
    """The three gates.  Persistence is read by a fresh store, as the
    next process reads it, after the shared view's clean-shutdown save
    (a torn last write inside the run is the torn-write tests' concern)."""
    from repro_torch.core.resilience import QuarantineStore, shared_quarantine

    shared_quarantine().save()
    persisted = len(QuarantineStore(
        os.environ["LILAC_TORCH_QUARANTINE_CACHE"]).active())
    return {
        "zero_uncontained_exceptions": not sweep["uncontained"],
        "results_match_oracle": not sweep["mismatches"] and all(
            p["ok"] for p in sweep["problems"].values()),
        "quarantines_persisted": persisted >= 1 if sweep["quarantines"]
        else True,
        "quarantine_records_on_disk": persisted,
    }


def run(seed: int, device: str, out_path=None, scratch=None) -> dict:
    scratch = scratch or tempfile.mkdtemp(prefix="lilac-torch-chaos-")
    redirect_stores(scratch)
    sweep = oracle_sweep(problem_suite(device), seed, device)
    report = {"benchmark": "chaos_smoke_torch", "seed": seed,
              "device": device, "spec": CHAOS_SPEC, "scratch": scratch,
              "oracle_sweep": sweep}
    report.update(gates(sweep))
    report["passed"] = (report["zero_uncontained_exceptions"]
                        and report["results_match_oracle"]
                        and report["quarantines_persisted"])
    report["repro_command"] = repro_command(seed, device, out_path)
    print(f"chaos_smoke_torch seed={seed} device={device}: "
          f"fired={sweep['faults_fired']} quarantines={sweep['quarantines']} "
          f"fallbacks={sweep['fallbacks']} "
          f"persisted={report['quarantine_records_on_disk']} "
          f"warnings={sweep['warnings']}")
    for gate in ("zero_uncontained_exceptions", "results_match_oracle",
                 "quarantines_persisted"):
        print(f"  {gate}: {report[gate]}")
    print(f"  repro: {report['repro_command']}")
    for u in sweep["uncontained"]:
        print(f"UNCONTAINED in {u['problem']}:\n{u['traceback']}",
              file=sys.stderr)
    if not report["passed"]:
        print(f"GATE FAILURE — replay this fault interleaving with:\n"
              f"  {report['repro_command']}", file=sys.stderr)
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps(report, indent=1,
                                             default=str) + "\n")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int,
                    default=int(os.environ.get("CHAOS_SEED", "0") or 0),
                    help="fault-plan seed (CHAOS_SEED by default)")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--out", default="", help="JSON report path ('' skips)")
    args = ap.parse_args(argv)
    report = run(args.seed, args.device, out_path=args.out or None)
    return 0 if report["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
