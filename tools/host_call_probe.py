#!/usr/bin/env python3
"""The host-mode interpreter's call time on one NVIDIA GPU with each of
two launch routes of K1/K2 and K3, in alternating pairs.

    python3 tools/host_call_probe.py [--pairs 12] [--calls 40] [--out PATH]

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit.  At ``chip_smoke.py``'s matrices (NAS CG class C's and HPCG's
104³ operator), the naive CSR SpMV compiled in host mode with
``bake=False``, so every call runs the interpreter (selection,
containment, the data plane, the harness), under ``cuda.ell`` (K1 staged
at NPB-C, K2 at HPCG) and ``cuda.bcsr`` (K3 narrow at HPCG).  The routes:

* ``direct``: the package as it is; a plain vector goes straight to the
  kernel's wrapper (``spmv_ell_packed``, ``bsr_spmm``);
* ``op``: every call through the custom op that a ``torch.func`` vector
  takes (``lilac_torch::spmv_ell_layout``, ``lilac_torch::bsr_spmm``).

Each pair times a block of ``--calls`` calls of each route (each call
from a sync to a sync, the block's median), the first route of a pair
alternating; the report gives each pair's difference (op minus direct)
and their median.  It prints the card's name and power limit first;
``--out`` writes the pairs as JSON.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CASES = (("npb", "cuda.ell"), ("hpcg", "cuda.ell"), ("hpcg", "cuda.bcsr"))


def op_routes():
    """The two wrappers with every call through their custom op (no bias:
    the naive SpMV has none)."""
    import torch
    from repro_torch.kernels.bsr_spmm import ops as bsr_ops
    from repro_torch.kernels.spmv_ell import ops as ell_ops
    from repro_torch.sparse.formats import BCSR, pack_bcsr

    def ell(packed, vec, epilogue=None, bias=None):
        assert bias is None
        return ell_ops.spmv_ell_layout_op(
            packed.val, packed.col, packed.seg_ptr, packed.seg_window,
            packed.seg_offset, packed.perm, vec, None, packed.window,
            packed.shape[0], packed.shape[1], epilogue)

    def bsr(bcsr, dense, epilogue=None, bias=None, bias_kind=None,
            out_rows=None):
        assert bias is None
        rows = bcsr.shape[0] if out_rows is None else out_rows
        packed = pack_bcsr(bcsr) if isinstance(bcsr, BCSR) else bcsr
        dtype = torch.promote_types(packed.val.dtype, dense.dtype)
        if packed.val.dtype != dtype:
            packed = dataclasses.replace(packed, val=packed.val.to(dtype))
        dense = dense.to(dtype).contiguous()
        return bsr_ops.bsr_spmm_op(
            packed.val, packed.local, packed.tile_ptr, packed.row_start,
            packed.col_mask, packed.block_col, packed.block_rowptr, dense,
            None, packed.shape[0], packed.shape[1], packed.block_shape[0],
            packed.block_shape[1], rows, None, epilogue)

    return {"direct": (ell_ops.spmv_ell_packed, bsr_ops.bsr_spmm),
            "op": (ell, bsr)}


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
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--calls", type=int, default=40)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as C
    from repro_torch import lilac
    from repro_torch.kernels.bsr_spmm import ops as bsr_ops
    from repro_torch.kernels.spmv_ell import ops as ell_ops

    print(f"card: {C.smi_line()}")
    routes = op_routes()

    def use(route):
        ell_ops.spmv_ell_packed, bsr_ops.bsr_spmm = routes[route]

    device = torch.device("cuda")
    mats = C.matrices(0, device)
    report = {"card": C.smi_line(), "cases": {}}
    for name, policy in CASES:
        a, b = mats[name]
        fast = lilac.compile(C.naive_spmv, mode="host", policy=policy,
                             bake=False, device=device)

        def call():
            return fast(a.val, a.col_ind, a.row_ptr, b)

        outs = {}
        for route in routes:                  # build, repack, warm
            use(route)
            for _ in range(5):
                outs[route] = call()
        assert torch.equal(outs["direct"], outs["op"]), name
        pairs = []
        for i in range(args.pairs):
            order = ("direct", "op") if i % 2 == 0 else ("op", "direct")
            got = {}
            for route in order:
                use(route)
                got[route] = block_ms(call, args.calls)
            pairs.append(got)
        use("direct")
        diffs = [p["op"] - p["direct"] for p in pairs]
        case = {"pairs": pairs, "diff_ms": diffs,
                "median_diff_ms": statistics.median(diffs),
                "op_slower": sum(d > 0 for d in diffs),
                "median_direct_ms": statistics.median(
                    p["direct"] for p in pairs),
                "median_op_ms": statistics.median(p["op"] for p in pairs)}
        report["cases"][f"{name} {policy}"] = case
        print(f"{name} {policy}: direct {case['median_direct_ms']:.4f} ms, "
              f"op {case['median_op_ms']:.4f} ms, op - direct by pair "
              + " ".join(f"{d:+.4f}" for d in diffs)
              + f" (median {case['median_diff_ms']:+.4f} ms, op slower in "
              f"{case['op_slower']} of {len(diffs)})")
        del fast
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
