#!/usr/bin/env python3
"""K1's direct body and K4's f32 body against an earlier version of their
sources, on one NVIDIA GPU.

    python3 tools/k1_k4_probe.py --parent DIR [--out PATH]

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit.  ``--parent DIR`` names a directory holding an earlier
``spmv_ell.cu`` and ``moe_gmm.cu`` (for instance from ``git show
1a7c2c5:src/repro_torch/kernels/spmv_ell/csrc/spmv_ell.cu``); they build
with the port's own flags (``repro_torch.kernels.build``) and are called
through their C entry points with the signatures they had at commit
1a7c2c5.  The tree's bodies are called through their wrappers.  At the
shapes of ``chip_smoke.py``:

* K1 (``spmv_ell_kernel``): NAS CG class C's matrix (150,000 rows, ~241
  entries a row) as lane-128 ELL (width 384, JDS-sorted), f32, in the
  three variants chip_smoke times (``main_path`` with the row
  permutation, ``relu_bias``, ``silu``) and with every column id set to 0
  (``no_gathers``: the same streams, every gather the same word), which
  separates the streams' cost from the gathers'; and its first
  ``chip_smoke.SMALL_ROWS`` rows at ``rows_per_slab`` 32 and 8 (the
  parent's tune clause), by the profiler, since a launch there is
  shorter than the host's enqueue;
* K4 (``gmm_simt_kernel``): OLMoE-1B-7B's gate/up call in f32 (the first
  sequence's routing, tm = 128), and ``torch._grouped_mm`` on the same
  operands.

Each is held against its plain version (atol = rtol = 1e-4 for K1, 1e-3
for K4) and timed with CUDA events over back-to-back launches, parent and
tree in turns (parent, tree, tree, parent), and with torch.profiler.  It
also prints ptxas's registers and the two bodies' SASS opcode counts
(``chip_smoke.sass_summary``).  ``--out`` writes every number as JSON.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

PARENT_DIR = ROOT / "build" / "k1_k4_probe"
SASS_KEYS = ("FFMA", "HMMA", "HGMMA", "LDS", "LDS.128", "LDG", "LDG.128",
             "STS", "STS.128", "BAR", "SHFL")


def parent_entry(lib, name: str, n_ptrs: int, n_ints: int):
    """The C function ``name`` of the parent's library, taking ``n_ptrs``
    pointers, ``n_ints`` ints and the stream."""
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def checked(err: int) -> None:
    if err:
        raise RuntimeError(f"launch failed: cudaError {err}")


def in_turns(fns: dict, time) -> dict:
    """``time(fn)`` of each of ``fns`` (name -> callable) in the order a, b,
    b, a: each name's mean over its two turns."""
    names = list(fns)
    seen: dict = {}
    for n in names + names[::-1]:
        seen.setdefault(n, []).append(time(fns[n]))
    return {n: {"ms": sum(t) / len(t), "turns": t} for n, t in seen.items()}


def k1_probe(parent_lib, seed: int, device, reps: int = 20):
    import torch
    from repro_torch.kernels.spmv_ell import kernel as K
    from repro_torch.kernels.spmv_ell import ref as R
    from repro_torch.sparse import ell_from_csr
    from repro_torch.sparse.random import random_spd_csr

    a = random_spd_csr(150_000, 241, seed=seed, device=device)
    ell = ell_from_csr(a, lane=128)
    rng = torch.Generator(device="cpu").manual_seed(seed + 1)
    vec = torch.randn(a.cols, generator=rng).to(device)
    bias = torch.randn(a.rows, generator=rng).to(device)
    width = ell.val.shape[1]
    stream = torch.cuda.current_stream().cuda_stream
    fn = parent_entry(parent_lib, "spmv_ell_f32", 6, 4)

    def parent(rows, kw, col=ell.col, rows_per_slab=32):
        perm, b = kw.get("perm"), kw.get("bias")
        code = {None: 0, "relu": 1, "silu": 2}[kw.get("epilogue")]

        def run():
            # allocated as the parent's wrapper did (zeros under perm)
            out = (torch.empty if perm is None else torch.zeros)(
                kw.get("out_rows", rows), device=device)
            checked(fn(ell.val.data_ptr(), col.data_ptr(), vec.data_ptr(),
                       None if b is None else b.data_ptr(),
                       None if perm is None else perm.data_ptr(),
                       out.data_ptr(), rows, width, rows_per_slab, code,
                       stream))
            return out
        return run

    def tree(rows, kw, col=ell.col, rows_per_slab=32):
        return lambda: K.spmv_ell_cuda(ell.val[:rows], col[:rows], vec,
                                       rows_per_slab=rows_per_slab, **kw)

    res = {"rows": a.rows, "width": width, "nnz": a.nnz, "variants": {}}
    variants = {"main_path": dict(perm=ell.perm, out_rows=a.rows),
                "relu_bias": dict(bias=bias, epilogue="relu"),
                "silu": dict(epilogue="silu")}
    zeros = torch.zeros_like(ell.col)
    cases = {v: (a.rows, kw, ell.col) for v, kw in variants.items()}
    cases["no_gathers"] = (a.rows, {}, zeros)
    for vname, (rows, kw, col) in cases.items():
        fns = {"parent": parent(rows, kw, col), "tree": tree(rows, kw, col)}
        outs = {n: f().clone() for n, f in fns.items()}
        torch.cuda.synchronize()
        plain = R.spmv_ell_plain(ell.val, col, vec, **kw)
        v = res["variants"][vname] = {}
        for n, got in outs.items():
            v[n + "_max_abs_err"], v[n + "_scaled_err"] = cs.max_err(got,
                                                                     plain)
        v.update(in_turns(fns, lambda f: cs.cuda_ms(f, reps)[0]))
        for n, f in fns.items():
            v[n]["profiler_ms"] = cs.profiled_ms(f, reps // 2,
                                                 "spmv_ell_kernel")["ms"]
    # the first SMALL_ROWS rows: fewer slabs than SMs at 32 rows a slab
    rows = min(a.rows, cs.SMALL_ROWS)
    kw = dict(bias=bias[:rows], epilogue="relu")
    fns = {f"{who} rows_per_slab={rs}": make(rows, kw, rows_per_slab=rs)
           for who, make in (("parent", parent), ("tree", tree))
           for rs in (32, 8)}
    plain = R.spmv_ell_plain(ell.val[:rows], ell.col[:rows], vec, **kw)
    small = res["small_rows"] = {"rows": rows}
    for n, f in fns.items():
        small[n + " scaled_err"] = cs.max_err(f(), plain)[1]
    small.update(in_turns(fns, lambda f: cs.profiled_ms(
        f, 2 * reps, "spmv_ell_kernel")["ms"]))
    csr_t = cs.sparse_csr(a)
    res["cusparse_ms"] = cs.cuda_ms(lambda: csr_t @ vec, reps)[0]
    io = cs.nbytes(vec, ell.perm) + a.rows * 4
    res["bound_ms"], res["bound_by"] = cs.bound_ms(a.nnz * 8 + io, 2 * a.nnz)
    res["slots_bound_ms"] = cs.bound_ms(a.rows * width * 8 + io, 0)[0]
    return res


def k4_probe(parent_lib, seed: int, device, reps: int = 10):
    import torch
    from repro_torch.configs.olmoe_1b_7b import CONFIG
    from repro_torch.kernels.moe_gmm import kernel as G
    from repro_torch.kernels.moe_gmm import ref as GR
    from repro_torch.kernels.moe_gmm.ops import _route
    from repro_torch.models import layers as L

    p, x = cs.moe_inputs(CONFIG, seed, device, batch=1)
    gate, idx, _ = L.moe_router(p, x, CONFIG.moe_topk)
    T, K = idx.shape[1:]
    E, D, F = p["wg"].shape
    tm = 128
    dest, te, tp = _route(idx[0], T, K, E, tm)
    xs = torch.zeros((tp, D), dtype=torch.float32, device=device)
    xs[dest] = x[0].float().repeat_interleave(K, dim=0)
    w = p["wg"].float()
    del p, x
    cs.release(device)
    want = GR.gmm_ref(xs, w, te, tm)
    stream = torch.cuda.current_stream().cuda_stream
    fn = parent_entry(parent_lib, "gmm_f32", 4, 5)
    out = torch.empty((tp, F), device=device)

    def run_parent():
        checked(fn(xs.data_ptr(), w.data_ptr(), te.data_ptr(),
                   out.data_ptr(), tp, D, F, E, tm, stream))
        return out
    fns = {"parent": run_parent, "tree": lambda: G.gmm_cuda(xs, w, te, tm)}
    outs = {n: f().clone() for n, f in fns.items()}
    counts = torch.bincount(idx[0].reshape(-1).long(), minlength=E)
    offs = torch.cumsum((counts + tm - 1) // tm * tm, 0).to(torch.int32)
    used = int(offs[-1])
    fns["library"] = lambda: torch._grouped_mm(xs, w, offs=offs)
    lib_err = float((fns["library"]()[:used] - want[:used]).abs().max())
    torch.cuda.synchronize()
    res = {"tp": tp, "routed_rows": T * K, "used_rows": used, "D": D, "F": F,
           "E": E, "library_max_abs_err": lib_err,
           "tree_equals_parent": bool(torch.equal(outs["tree"],
                                                  outs["parent"]))}
    for n, got in outs.items():
        res[n + "_max_abs_err"], res[n + "_scaled_err"] = cs.max_err(
            got, want, cs.GMM_ATOL, cs.GMM_RTOL)
        res[n + "_tail_zero"] = bool((got[used:] == 0).all())
    res.update(in_turns(fns, lambda f: cs.cuda_ms(f, reps)[0]))
    for n in ("parent", "tree"):
        res[n]["profiler_ms"] = cs.profiled_ms(fns[n], reps // 2,
                                               "gmm_simt_kernel")["ms"]
    flops = 2 * T * K * D * F
    nb = T * K * D * 4 + w.numel() * 4 + T * K * F * 4
    res["bound_ms"], res["bound_by"] = cs.bound_ms(nb, flops)
    for n in fns:
        res[n]["tflops_routed"] = flops / res[n]["ms"] / 1e9
        res[n]["tflops_padded"] = 2 * tp * D * F / res[n]["ms"] / 1e9
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import build
    from repro_torch.kernels.moe_gmm import kernel as G
    from repro_torch.kernels.spmv_ell import kernel as K

    device = torch.device("cuda")
    record = {"card": cs.smi_line(), "sass": {}}
    print(f"card: {record['card']}")
    PARENT_DIR.mkdir(parents=True, exist_ok=True)
    sources = {"tree": [K.SOURCE, G.SOURCE], "parent": []}
    for s in (K.SOURCE, G.SOURCE):
        dst = PARENT_DIR / s.name
        shutil.copyfile(args.parent / s.name, dst)
        sources["parent"].append(dst)
    build.build_all(sources["tree"] + sources["parent"])
    libs = {}
    for who, srcs in sources.items():
        for s in srcs:
            for line in build.build_log(s).splitlines():
                if any(k in line for k in ("registers", "spill", "Compiling")):
                    print(f"  ptxas {who} {s.name}: {line.strip()}")
            for fname, counts in cs.sass_functions(
                    build.library_path(s)).items():
                if "spmv_ell_kernel" in fname or "gmm_simt_kernel" in fname:
                    summary = {k: v for k, v in
                               cs.sass_summary(counts).items()
                               if k in SASS_KEYS}
                    record["sass"][f"{who} {fname}"] = summary
                    print(f"  sass {who} {fname}: {summary}")
        libs[who] = {s.stem: build.load(s) for s in srcs}
    record["k1"] = k1_probe(libs["parent"]["spmv_ell"], args.seed, device)
    print(f"k1: {json.dumps(record['k1'])}")
    cs.release(device)
    record["k4"] = k4_probe(libs["parent"]["moe_gmm"], args.seed, device)
    print(f"k4: {json.dumps(record['k4'])}")
    print(f"card: {cs.smi_line()}")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
