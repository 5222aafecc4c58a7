#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--record PATH]

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit.  It imports nothing of JAX or of the JAX package, and:

1. prints the card's name and power limit (nvidia-smi);
2. builds every CUDA kernel of the SpMV path from the sources in the
   checkout (one nvcc per source, all started together);
3. drives the main path through ``repro_torch.lilac.compile`` — the
   paper's Fig. 1 flow — with the kernels' launch counts set to 0 just
   before and read just after:
   * 25 CG iterations (NPB CG's cgitmax) on a seeded symmetric, diagonally
     dominant 150,000-row matrix with ~241 entries a row (NAS CG class C's
     na=150000 and ~36 M stored entries), calling a naive torch CSR SpMV
     compiled with policy="cuda.ell": the resident ELL kernel (K1);
   * 25 CG iterations on HPCG's 27-point operator over its default local
     grid, 104^3 = 1,124,864 rows: a vector over 1<<20 elements, so the
     column-windowed ELL kernel (K2);
   * a direct ELL SpMV with a relu(... + bias) tail under the default
     policy, which must reach K1 with the fused epilogue;
   then checks that one spmv_csr/CSR match was found, cuda.ell selected,
   the matrix repacked once, each kernel launched once per SpMV call, and
   that each CG iterate agrees with the same CG on the uncompiled naive
   SpMV on the card;
4. holds each kernel against its plain torch version at the main path's
   shapes, with and without the fused epilogues, and times the kernel, the
   plain version and, as a yardstick never called by the port, one
   cuSPARSE SpMV on the same matrix (``torch.sparse_csr_tensor @ vec``),
   beside the least time the card could take for the SpMV itself: the
   matrix's stored entries (value and column), the vector, the output and
   the row permutation, each moved once, at 3.35 TB/s, against 2 flops a
   stored entry at 67 TFLOP/s f32 (the padded layouts' own bytes are
   printed beside it);
5. prints one JSON line with every kernel's numbers and, last, the
   {"ok": true, "device": ...} line; ``--record PATH`` also writes a
   detailed JSON record there.  Any failure exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_FLOPS = 67e12              # H100 SXM f32 rate outside the tensor cores
CG_ITERS = 25                  # NPB CG's cgitmax
CG_RTOL = 1e-3                 # |x - x_naive| / |x_naive| after 25 iterations
KERNEL_ATOL = KERNEL_RTOL = 1e-4


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def naive_spmv(val, col, row_ptr, v):
    """The application's textbook CSR SpMV (examples/quickstart.py)."""
    import torch

    rows = row_ptr.shape[0] - 1
    row = torch.repeat_interleave(torch.arange(rows, device=val.device),
                                  torch.diff(row_ptr), output_size=val.shape[0])
    out = torch.zeros(rows, dtype=val.dtype, device=val.device)
    return out.index_add_(0, row, val * v[col])


def ell_layer(val, col, vec, bias):
    """A direct ELL SpMV with a fused-epilogue tail."""
    import torch

    return torch.relu((val * vec[col]).sum(dim=1) + bias)


def cg(spmv, csr, b, iters):
    """Unpreconditioned CG as examples/cg_solver.py writes it, run for a
    fixed number of iterations (no early exit)."""
    import torch

    x = torch.zeros_like(b)
    r = b - spmv(csr.val, csr.col_ind, csr.row_ptr, x)
    p = r
    rs = torch.dot(r, r)
    for _ in range(iters):
        ap = spmv(csr.val, csr.col_ind, csr.row_ptr, p)
        alpha = rs / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.dot(r, r)
        p = r + (rs_new / rs) * p
        rs = rs_new
    return x


def cuda_ms(fn, reps: int):
    """(device ms, host ms) per call of ``fn`` over ``reps`` back-to-back
    calls, after one warm-up call: the device time from CUDA events, the
    host time to enqueue them.  Where the host takes as long as the
    device, the events time the host's gaps, not the kernel."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, 1e3 * host / reps


def profiled_ms(fn, reps: int, kernel: str):
    """Mean device time per launch of the CUDA kernels whose name holds
    ``kernel``, from torch.profiler over ``reps`` calls of ``fn`` (None if
    the profiler records no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings():     # "clears events" notice
        warnings.simplefilter("ignore")
        prof = profile(activities=[ProfilerActivity.CUDA])
    with prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [e.device_time_total / e.count for e in prof.key_averages()
             if kernel in e.key and e.count and e.device_time_total > 0]
    return sum(times) / 1e3 if times else None


def bound_ms(nbytes: int, flops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def max_err(got, want):
    """(max |got - want|, max of that over atol + rtol*|want|)."""
    import torch

    diff = (got - want).abs()
    return float(diff.max()), float((diff / (KERNEL_ATOL + KERNEL_RTOL
                                             * want.abs())).max())


def matrices(seed: int, device, npb=(150_000, 241), hpcg=(104, 104, 104)):
    """The two matrices, built in numpy directly in CSR and moved to the
    device, with the CG right-hand sides: NPB's b = 1, HPCG's b = A @ 1."""
    import torch
    from repro_torch.sparse.random import random_spd_csr, stencil27_csr

    a_npb = random_spd_csr(npb[0], npb[1], seed=seed, device=device)
    a_hpcg = stencil27_csr(*hpcg, device=device)
    b_npb = torch.ones(a_npb.rows, device=device)
    b_hpcg = torch.zeros(a_hpcg.rows, device=device).index_add_(
        0, torch.repeat_interleave(
            torch.arange(a_hpcg.rows, device=device),
            torch.diff(a_hpcg.row_ptr).long()), a_hpcg.val)
    return {"npb": (a_npb, b_npb), "hpcg": (a_hpcg, b_hpcg)}


def timed(fn, seconds: list, sync: bool):
    """``fn`` with the wall time of each call appended to ``seconds``
    (synchronised, so a call's time is its host and device work)."""
    import torch

    def call(*args):
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        if sync:
            torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return out

    return call


def main_path(mats, seed: int, device, iters: int = CG_ITERS):
    """Drive the port's entry points; return what the checks need."""
    import torch
    from repro_torch import lilac
    from repro_torch.kernels.spmv_ell import kernel as K
    from repro_torch.sparse import ell_from_csr

    rng = torch.Generator(device="cpu").manual_seed(seed)
    a_npb = mats["npb"][0]
    ell = ell_from_csr(a_npb, lane=128)
    vec = torch.randn(a_npb.cols, generator=rng).to(device)
    bias = torch.randn(a_npb.rows, generator=rng).to(device)
    out = {}
    compiled = {name: lilac.compile(naive_spmv, mode="host",
                                    policy="cuda.ell", device=device)
                for name in mats}
    layer = lilac.compile(ell_layer, mode="host", device=device)
    peaks, kept = {}, {}
    K.reset_launches()
    for name, (a, b) in mats.items():
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
        calls: list = []
        t0 = time.perf_counter()
        x = cg(timed(compiled[name], calls, device.type == "cuda"), a, b,
               iters)
        if device.type == "cuda":
            torch.cuda.synchronize()
            peaks[name] = torch.cuda.max_memory_allocated()
            # what the data plane keeps on the card for this matrix
            kept[name] = torch.cuda.memory_allocated() - before
        steady = sorted(calls[1:])
        out[name] = {"x": x, "seconds": time.perf_counter() - t0,
                     "first_call_s": calls[0],
                     "steady_call_ms": 1e3 * steady[len(steady) // 2]}
    y = layer(ell.val, ell.col, vec, bias)
    launches = dict(K.LAUNCHES)
    # references, after the counts were read
    for name, (a, b) in mats.items():
        fast = compiled[name]
        x_ref = cg(naive_spmv, a, b, iters)
        x = out[name]["x"]
        rel = float(torch.linalg.vector_norm(x - x_ref)
                    / torch.linalg.vector_norm(x_ref))
        resid = float(torch.linalg.vector_norm(
            b - naive_spmv(a.val, a.col_ind, a.row_ptr, x))
            / torch.linalg.vector_norm(b))
        (m,) = fast.last_report.matches
        out[name].update(
            rows=a.rows, nnz=a.nnz, rel_to_naive=rel, residual=resid,
            finite=bool(torch.isfinite(x).all()), shape=tuple(x.shape),
            match=(m.computation, m.format),
            selections=[n for _, n in fast.last_selections],
            repacks=fast.cache.stats.misses, hits=fast.cache.stats.hits,
            repack_seconds=fast.cache.plans["csr_binding", "ELL128"]
            .build_seconds, trace_seconds=fast.stats["trace_seconds"],
            detect_seconds=fast.stats["detect_seconds"],
            peak_bytes=peaks.get(name), kept_bytes=kept.get(name), x=None)
    (lm,) = layer.last_report.matches
    y_ref = ell_layer(ell.val, ell.col, vec, bias)
    out["ell_layer"] = {
        "match": (lm.computation, lm.format, lm.epilogue),
        "selections": [n for _, n in layer.last_selections],
        "max_abs_err": max_err(y, y_ref)[0],
        "within_tol": max_err(y, y_ref)[1] <= 1.0,
    }
    out["launches"] = launches
    return out


def check_main_path(res, iters: int = CG_ITERS) -> None:
    calls = iters + 1                   # one SpMV for r0, one per iteration
    for name, kernel in (("npb", "spmv_ell"), ("hpcg", "spmv_ell_windowed")):
        r = res[name]
        require(r["match"] == ("spmv_csr", "CSR"),
                f"{name}: one spmv_csr/CSR match, got {r['match']}")
        require(r["selections"] == ["cuda.ell"],
                f"{name}: cuda.ell selected, got {r['selections']}")
        require(r["repacks"] == 1, f"{name}: one repack, got {r['repacks']}")
        require(r["finite"] and r["shape"] == (r["rows"],),
                f"{name}: finite iterate of shape ({r['rows']},)")
        require(r["rel_to_naive"] <= CG_RTOL,
                f"{name}: CG iterate within {CG_RTOL} of the naive CG, "
                f"got {r['rel_to_naive']:.3g}")
    lay = res["ell_layer"]
    require(lay["match"] == ("spmv_ell", "ELL", "relu"),
            f"ELL layer: spmv_ell/ELL +relu, got {lay['match']}")
    require(lay["selections"] == ["cuda.ell"],
            f"ELL layer: cuda.ell under the default policy, got "
            f"{lay['selections']}")
    require(lay["within_tol"], "ELL layer output within tolerance")
    launches = res["launches"]
    require(launches["spmv_ell"] == calls + 1,
            f"K1 launched once per NPB SpMV and once for the layer "
            f"({calls + 1}), got {launches['spmv_ell']}")
    require(launches["spmv_ell_windowed"] == calls,
            f"K2 launched once per HPCG SpMV ({calls}), got "
            f"{launches['spmv_ell_windowed']}")


def kernel_phases(mats, seed: int, device, reps: int = 20):
    """Each kernel against its plain version at the main path's shapes."""
    import torch
    from repro_torch.kernels.spmv_ell import kernel as K
    from repro_torch.kernels.spmv_ell import ref as R
    from repro_torch.sparse import ell_from_csr, ell_windows

    rng = torch.Generator(device="cpu").manual_seed(seed + 1)
    on_card = device.type == "cuda"
    rows = []
    for name, kernel, (a, _) in (("npb", "spmv_ell", mats["npb"]),
                                 ("hpcg", "spmv_ell_windowed", mats["hpcg"])):
        ell = ell_from_csr(a, lane=128)
        vec = torch.randn(a.cols, generator=rng).to(device)
        bias = torch.randn(a.rows, generator=rng).to(device)
        if kernel == "spmv_ell":
            ops = (ell.val, ell.col)
            shape = tuple(ell.val.shape)
            run = lambda **kw: K.spmv_ell_cuda(ell.val, ell.col, vec, **kw)
            plain = lambda **kw: R.spmv_ell_plain(ell.val, ell.col, vec, **kw)
        else:
            w = ell_windows(ell.val, ell.col, a.cols, perm=ell.perm)
            ops = (w.val, w.col)
            shape = tuple(w.val.shape)
            run = lambda **kw: K.spmv_ell_windowed_cuda(
                w.val, w.col, vec, window=w.window, **kw)
            plain = lambda **kw: R.spmv_ell_windowed_plain(
                w.val, w.col, vec, window=w.window, **kw)
        with warnings.catch_warnings():     # "beta state" notice
            warnings.simplefilter("ignore")
            csr_t = torch.sparse_csr_tensor(a.row_ptr.long(),
                                            a.col_ind.long(), a.val,
                                            size=a.shape,
                                            check_invariants=False)
        variants = {
            # as the CG path calls it: the store un-permutes the row sort
            "main_path": dict(perm=ell.perm, out_rows=a.rows),
            "relu_bias": dict(bias=bias, epilogue="relu"),
            "silu": dict(epilogue="silu"),
        }
        entry = {"name": kernel, "matrix": name, "shape": shape, "variants": {}}
        for vname, kw in variants.items():
            got = run(**kw)
            want = plain(**kw)
            if on_card:
                torch.cuda.synchronize()
            err, scaled = max_err(got, want)
            require(scaled <= 1.0, f"{kernel}/{vname}: max |err| {err:.3g} "
                    f"within atol={KERNEL_ATOL} + rtol={KERNEL_RTOL}*|ref|")
            io = nbytes(vec, kw.get("bias"), kw.get("perm"), got)
            # the stored entries, not the layout's padded slots
            nb = a.nnz * (a.val.element_size() + a.col_ind.element_size()) + io
            b_ms, b_by = bound_ms(nb, 2 * a.nnz)
            ms, host_ms = cuda_ms(lambda: run(**kw), reps) if on_card \
                else (None, None)
            prof_ms = profiled_ms(lambda: run(**kw), reps, kernel + "_kernel") \
                if on_card else None
            plain_ms = cuda_ms(lambda: plain(**kw), 3)[0] if on_card else None
            entry["variants"][vname] = {
                "max_abs_err": err, "scaled_err": scaled, "ms": ms,
                "host_ms": host_ms, "profiler_ms": prof_ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "bytes": nb, "layout_bytes": nbytes(*ops) + io}
            del got, want
        entry["library_ms"] = cuda_ms(lambda: csr_t @ vec, reps)[0] \
            if on_card else None
        # the yardstick computes the same function
        entry["library_err"] = float((csr_t @ vec - R.spmv_ell_plain(
            ell.val, ell.col, vec, perm=ell.perm, out_rows=a.rows))
            .abs().max())
        rows.append(entry)
        del ell, csr_t
    return rows


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--record", type=Path, default=None,
                    help="write a detailed JSON record to this path")
    args = ap.parse_args()
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke.py must run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = smi_line()
    print(f"card: {smi}")
    device = torch.device("cuda")

    from repro_torch.kernels import build
    from repro_torch.kernels.spmv_ell import kernel as K

    t0 = time.perf_counter()
    build.build_all([K.SOURCE])
    print(f"built {K.SOURCE.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.1f}s")
    for line in build.build_log(K.SOURCE).splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")

    t0 = time.perf_counter()
    mats = matrices(args.seed, device)
    for name, (a, _) in mats.items():
        print(f"matrix {name}: {a.rows} rows, {a.nnz} stored entries")
    print(f"generated in {time.perf_counter() - t0:.1f}s")

    res = main_path(mats, args.seed, device)
    for name in mats:
        r = res[name]
        print(f"main path {name}: match {r['match']} via {r['selections']}, "
              f"traced in {r['trace_seconds']:.2f}s, detected in "
              f"{r['detect_seconds']:.2f}s, "
              f"{r['repacks']} repack ({r['repack_seconds']:.2f}s), "
              f"{r['hits']} hits; CG {CG_ITERS} it in {r['seconds']:.2f}s "
              f"(first call {r['first_call_s']:.2f}s, then "
              f"{r['steady_call_ms']:.3f} ms a call), "
              f"|x-x_naive|/|x_naive| = {r['rel_to_naive']:.3g} "
              f"(tol {CG_RTOL}), residual {r['residual']:.3g}, peak "
              f"{r['peak_bytes'] / 2**30:.2f} GiB, kept after the CG "
              f"{r['kept_bytes'] / 2**30:.2f} GiB")
    print(f"main path ELL layer: {res['ell_layer']}")
    print(f"launches on the main path: {res['launches']}")
    check_main_path(res)

    rows = kernel_phases(mats, args.seed, device)
    kernels = []
    replaces = {"spmv_ell": "src/repro/kernels/spmv_ell/kernel.py:57",
                "spmv_ell_windowed": "src/repro/kernels/spmv_ell/kernel.py:125"}
    for e in rows:
        for vname, v in e["variants"].items():
            print(f"{e['name']} {e['shape']} {vname}: max|err| "
                  f"{v['max_abs_err']:.3g} (tol atol={KERNEL_ATOL} + "
                  f"rtol={KERNEL_RTOL}*|ref|), {v['ms']:.4f} ms (host "
                  f"{v['host_ms']:.4f} ms to enqueue; profiler "
                  f"{v['profiler_ms']} ms a launch), plain "
                  f"{v['plain_ms']:.4f} ms, bound {v['bound_ms']:.4f} ms "
                  f"({v['bound_by']}, {v['bytes']} B with the stored "
                  f"entries; the padded layout moves {v['layout_bytes']} B)")
        print(f"{e['name']} library (cuSPARSE CSR SpMV): "
              f"{e['library_ms']:.4f} ms, max|err| vs plain "
              f"{e['library_err']:.3g}")
        main = e["variants"]["main_path"]
        kernels.append({
            "name": e["name"], "route": "cuda",
            "source": "src/repro_torch/kernels/spmv_ell/csrc/spmv_ell.cu",
            "replaces": replaces[e["name"]],
            "launches": res["launches"][e["name"]],
            "max_abs_err": max(v["max_abs_err"]
                               for v in e["variants"].values()),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": e["library_ms"]})

    if args.record is not None:
        args.record.parent.mkdir(parents=True, exist_ok=True)
        args.record.write_text(json.dumps(
            {"card": smi, "main_path": res, "kernels": rows,
             "seconds": time.perf_counter() - t_start}, indent=1,
            default=str))
    print(f"total {time.perf_counter() - t_start:.1f}s")
    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
