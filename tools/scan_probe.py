#!/usr/bin/env python3
"""Where the host time of a CG compiled whole as one scan goes, on one
NVIDIA GPU.

    python3 tools/scan_probe.py [--matrix npb|hpcg] [--calls 3] [--out PATH]

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit.  At ``chip_smoke.py``'s matrix (NAS CG class C's, or HPCG's
104³ operator), ``chip_smoke.cg_scan`` compiled in host mode under
``policy="cuda.ell"``, after two warm calls:

* the synchronizing CUDA operations of one call, by call site, from
  torch's sync debug mode (``torch.cuda.set_sync_debug_mode("warn")``);
* the ms of a solve of the compiled scan, of the per-iteration CG on
  baked plans (``chip_smoke.cg``) and of the same CG as a plain Python
  loop over the naive SpMV, each from a sync to a sync over ``--calls``;
* a cProfile of ``--calls`` calls of the compiled scan, by own time.

It prints the card's name and power limit first; ``--out`` writes the
sync sites and the three times as JSON.
"""
from __future__ import annotations

import argparse
import collections
import cProfile
import io
import json
import os
import pstats
import sys
import tempfile
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def sync_sites(fn) -> collections.Counter:
    """The synchronizing CUDA operations of one call of ``fn``, counted by
    their last frames."""
    import torch

    sites: collections.Counter = collections.Counter()

    def note(*_args, **_kw):
        frames = [f"{Path(f.filename).name}:{f.lineno}:{f.name}"
                  for f in traceback.extract_stack()[:-1]
                  if "warnings" not in f.filename][-6:]
        sites[" < ".join(reversed(frames))] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sites


def solve_ms(fn, calls: int) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--matrix", choices=("npb", "hpcg"), default="npb")
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    work = tempfile.mkdtemp(prefix="lilac-torch-scan-probe-")
    for name, file in (("AUTOTUNE", "autotune"), ("PLAN", "plans"),
                       ("QUARANTINE", "quarantine")):
        os.environ[f"LILAC_TORCH_{name}_CACHE"] = f"{work}/{file}.json"
    torch.backends.cuda.matmul.allow_tf32 = False

    import chip_smoke as cs
    from repro_torch import lilac
    from repro_torch.kernels import build
    from repro_torch.kernels.spmv_ell import kernel as K

    print(f"card: {cs.smi_line()}")
    build.build_all([K.SOURCE])
    device = torch.device("cuda")
    a, b = cs.matrices(0, device)[args.matrix]
    operands = (a.val, a.col_ind, a.row_ptr, b)
    fast = lilac.compile(cs.cg_scan, mode="host", policy="cuda.ell",
                         device=device)
    per_iter = lilac.compile(cs.naive_spmv, mode="host", policy="cuda.ell",
                             device=device)
    for _ in range(2):
        fast(*operands)
        cs.cg(per_iter, a, b, cs.CG_ITERS)
    sites = sync_sites(lambda: fast(*operands))
    print(f"syncs in one call of the compiled scan: {sum(sites.values())}")
    for site, n in sites.most_common():
        print(f"  {n} {site}")
    ms = {"compiled_scan": solve_ms(lambda: fast(*operands), args.calls),
          "per_iteration_cg": solve_ms(
              lambda: cs.cg(per_iter, a, b, cs.CG_ITERS), args.calls),
          "python_loop_cg": solve_ms(
              lambda: cs.cg(cs.naive_spmv, a, b, cs.CG_ITERS), args.calls)}
    print(f"{args.matrix} a solve, ms: {ms}")
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(args.calls):
        fast(*operands)
    torch.cuda.synchronize()
    prof.disable()
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(30)
    print(text.getvalue())
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": cs.smi_line(),
                                        "matrix": args.matrix,
                                        "syncs": dict(sites), "ms": ms},
                                       indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
