#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--record PATH]

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit.  It imports nothing of JAX or of the JAX package, and:

1. prints the card's name and power limit (nvidia-smi);
2. builds every CUDA kernel of the port from the sources in the checkout
   (one nvcc per source, all started together), prints ptxas's registers
   and shared memory, and checks with cuobjdump that K4's bf16 body runs
   on the tensor cores (HGMMA in its SASS);
3. drives each path through ``repro_torch.lilac.compile`` — the paper's
   Fig. 1 flow — with the kernels' launch counts set to 0 just before the
   path and read just after, and checks what came out:
   * SpMV on ELL (K1, K2): 25 CG iterations (NPB CG's cgitmax) on a
     seeded symmetric, diagonally dominant 150,000-row matrix with ~241
     entries a row (NAS CG class C's na=150000, ~36 M stored entries; K1's
     staged body, the vector in shared memory in 3 windows) and on HPCG's
     27-point operator over its default local grid, 104^3 = 1,124,864 rows
     (K2), each calling a naive CSR SpMV compiled with policy="cuda.ell";
     then a relu(ELL SpMV + bias) layer under the default policy (K1's
     direct body with the fused epilogue).  Checks: one spmv_csr/CSR
     match, cuda.ell, one repack, one launch a call of the body the path
     takes, and the CG iterate against the same CG on the uncompiled naive
     SpMV;
   * SpMM on BCSR (K3): a mesh-GNN aggregation, 15 steps (MeshGraphNets'
     message-passing steps) of H <- relu(A @ H + b) over the HPCG operator
     with H of 128 columns (MeshGraphNets' latent size), H rescaled by its
     largest magnitude after each step outside the compiled part, under
     the default policy: one spmm_csr/CSR match with the fused relu-bias
     epilogue, cuda.bcsr, one repack into packed 128x128 tiles (each
     tile's entries only: at most 0.25 GB, no dense tile) and 14 hits, 15
     launches of K3's wide body, and the final H against the same loop on
     the uncompiled naive SpMM;
   * SpMV on BCSR (K3 at N = 1): 25 CG iterations on the HPCG operator
     with policy="cuda.bcsr": 26 launches of K3's narrow body, one
     repack, the CG check;
   * MoE (K4): one OLMoE-1B-7B expert layer (d_model 2048, 64 experts of
     d_ff 1024, top-8, bf16; seeded weights) over two sequences of 4,096
     tokens through moe_block(impl="lilac") under the default policy: one
     moe_ffn/MOE match traced once, cuda.gmm, 6 launches (3 a sequence),
     and the output and the naive bf16 block's, each as relative L2 error
     against the f32 plain oracle on the same bf16 inputs;
4. holds each kernel against its plain torch version at the paths' shapes
   (every fused epilogue; f32 and bf16 for K3 and K4) and times the
   kernel (CUDA events, host enqueue, torch.profiler), the plain version
   and one PyTorch call of the same function that the port never calls
   (cuSPARSE SpMV and SpMM, torch._grouped_mm; for K4 also a bf16 GEMM of
   the same flops as a rate yardstick), beside the least time the card
   could take for the function's own work at the widths the layout stores
   (bound_ms); prints the layouts' bytes (checks: K1's staged layout at
   NPB-C at most 0.33 GB, K2's at HPCG 0.31 GB, K3's packed tiles at HPCG
   0.25 GB; and the packed tiles cuda.bcsr would build for NPB-C), the L2
   bytes of K3's operand re-reads, and K4's achieved TFLOP/s over the
   routed and over all padded rows;
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
PEAK_FLOPS = {                 # H100 SXM, dense
    "torch.float32": 67e12,    # f32 outside the tensor cores
    "torch.bfloat16": 989e12,  # bf16 tensor cores
}
CG_ITERS = 25                  # NPB CG's cgitmax
CG_RTOL = 1e-3                 # |x - x_naive| / |x_naive| after 25 iterations
GNN_STEPS = 15                 # MeshGraphNets' message-passing steps
GNN_WIDTH = 128                # MeshGraphNets' latent size
# |H - H_naive| / |H_naive| after 15 steps: f32 sums of 27 terms in
# another order, carried through relu and the rescale
GNN_RTOL = 1e-4
MOE_BATCH, MOE_SEQ = 2, 4096   # OLMoE's context length
# relative L2 error against the f32 oracle: bf16 keeps 8 significant bits
# (a rounding error up to 2^-9 = 2e-3 relative); the routed path rounds h
# and its output to bf16, the naive bf16 block every einsum's output
MOE_RTOL = 2e-2
KERNEL_ATOL = KERNEL_RTOL = 1e-4   # K1-K3 against their plain versions
# K4: f32 sums of 1,024 or 2,048 products, in another order than cuBLAS's
GMM_ATOL = GMM_RTOL = 1e-3
K1_LAYOUT_BYTES = 0.33e9       # K1's staged layout at NPB-C
K2_LAYOUT_BYTES = 0.31e9       # K2's compacted layout at HPCG-104^3
K3_LAYOUT_BYTES = 0.25e9       # K3's packed tiles at HPCG-104^3


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


def gnn_step(val, col, row_ptr, h, bias):
    """One aggregation step of a mesh GNN: relu(A @ H + b), with A @ H the
    textbook CSR SpMM (benchmarks/tab3_detection.py)."""
    import torch

    rows = row_ptr.shape[0] - 1
    row = torch.repeat_interleave(torch.arange(rows, device=val.device),
                                  torch.diff(row_ptr), output_size=val.shape[0])
    out = torch.zeros((rows, h.shape[1]), dtype=h.dtype, device=h.device)
    return torch.relu(out.index_add_(0, row, val[:, None] * h[col]) + bias)


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


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def release(device) -> None:
    """Give the caching allocator's free blocks back before the next path."""
    import gc

    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


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


def bound_ms(nbytes: int, flops: int, dtype="torch.float32"):
    """The least time the card could take: the larger of the bytes over its
    memory rate and the operations over its peak rate for ``dtype``."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(dtype)]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def layout_bytes(layout) -> int:
    """Bytes of every tensor a layout (a container dataclass) holds."""
    import dataclasses

    import torch

    return nbytes(*(getattr(layout, f.name) for f in dataclasses.fields(layout)
                    if isinstance(getattr(layout, f.name), torch.Tensor)))


def marshaled(fast, kind):
    """The values of class ``kind`` that a compiled function's data plane
    holds (the marshaled layouts)."""
    return [v for v in fast.cache._store.values() if isinstance(v, kind)]


def max_err(got, want, atol=KERNEL_ATOL, rtol=KERNEL_RTOL):
    """(max |got - want|, max of that over atol + rtol*|want|)."""
    diff = (got.float() - want.float()).abs()
    return float(diff.max()), float((diff / (atol + rtol * want.float().abs()))
                                    .max())


def rel_l2(got, want) -> float:
    import torch

    return float(torch.linalg.vector_norm(got.float() - want.float())
                 / torch.linalg.vector_norm(want.float()))


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


def timed(fn, seconds: list, device):
    """``fn`` with the wall time of each call appended to ``seconds``
    (synchronised, so a call's time is its host and device work)."""
    def call(*args):
        sync(device)
        t0 = time.perf_counter()
        out = fn(*args)
        sync(device)
        seconds.append(time.perf_counter() - t0)
        return out

    return call


def memory_mark(device):
    """Reset the peak counter; the bytes allocated now."""
    import torch

    if device.type != "cuda":
        return None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def memory_read(device, before):
    """(peak bytes since the mark, bytes kept since the mark)."""
    import torch

    if device.type != "cuda":
        return None, None
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated(),
            torch.cuda.memory_allocated() - before)


def steady_ms(calls):
    steady = sorted(calls[1:]) or calls
    return 1e3 * steady[len(steady) // 2]


# ---------------------------------------------------------------------------
# SpMV on ELL: K1, K2
# ---------------------------------------------------------------------------

def main_path(mats, seed: int, device, iters: int = CG_ITERS):
    """Drive the SpMV paths; return what the checks need (and, under
    "x_ref", each matrix's naive CG iterate)."""
    import torch
    from repro_torch import lilac
    from repro_torch.kernels.spmv_ell import kernel as K
    from repro_torch.sparse import WindowedELL, ell_from_csr

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
    K.reset_launches()
    for name, (a, b) in mats.items():
        before = memory_mark(device)
        calls: list = []
        t0 = time.perf_counter()
        x = cg(timed(compiled[name], calls, device), a, b, iters)
        peak, kept = memory_read(device, before)
        out[name] = {"x": x, "seconds": time.perf_counter() - t0,
                     "first_call_s": calls[0],
                     "steady_call_ms": steady_ms(calls),
                     "peak_bytes": peak, "kept_bytes": kept}
    y = layer(ell.val, ell.col, vec, bias)
    launches = dict(K.LAUNCHES)
    # references, after the counts were read
    x_refs = {}
    for name, (a, b) in mats.items():
        fast = compiled[name]
        x_ref = x_refs[name] = cg(naive_spmv, a, b, iters)
        x = out[name].pop("x")
        resid = float(torch.linalg.vector_norm(
            b - naive_spmv(a.val, a.col_ind, a.row_ptr, x))
            / torch.linalg.vector_norm(b))
        (m,) = fast.last_report.matches
        (layout,) = marshaled(fast, WindowedELL)
        out[name].update(
            layout_bytes=layout_bytes(layout), window=layout.window,
            windows=layout.n_windows,
            rows=a.rows, nnz=a.nnz, rel_to_naive=rel_l2(x, x_ref),
            residual=resid, finite=bool(torch.isfinite(x).all()),
            shape=tuple(x.shape), match=(m.computation, m.format),
            selections=[n for _, n in fast.last_selections],
            repacks=fast.cache.stats.misses, hits=fast.cache.stats.hits,
            repack_seconds=fast.cache.plans["csr_binding", "ELL128"]
            .build_seconds, trace_seconds=fast.stats["trace_seconds"],
            detect_seconds=fast.stats["detect_seconds"])
    (lm,) = layer.last_report.matches
    y_ref = ell_layer(ell.val, ell.col, vec, bias)
    out["ell_layer"] = {
        "match": (lm.computation, lm.format, lm.epilogue),
        "selections": [n for _, n in layer.last_selections],
        "max_abs_err": max_err(y, y_ref)[0],
        "within_tol": max_err(y, y_ref)[1] <= 1.0,
    }
    out["launches"] = launches
    out["x_ref"] = x_refs
    return out


def check_main_path(res, iters: int = CG_ITERS) -> None:
    calls = iters + 1                   # one SpMV for r0, one per iteration
    for name in ("npb", "hpcg"):
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
    require(res["npb"]["layout_bytes"] <= K1_LAYOUT_BYTES,
            f"NPB: K1's staged layout within {K1_LAYOUT_BYTES} B, got "
            f"{res['npb']['layout_bytes']} B")
    launches = res["launches"]
    require(launches["spmv_ell_staged"] == calls,
            f"K1's staged body launched once per NPB SpMV ({calls}), got "
            f"{launches['spmv_ell_staged']}")
    require(launches["spmv_ell"] == 1,
            f"K1's direct body launched once, for the ELL layer, got "
            f"{launches['spmv_ell']}")
    require(launches["spmv_ell_windowed"] == calls,
            f"K2 launched once per HPCG SpMV ({calls}), got "
            f"{launches['spmv_ell_windowed']}")


def variant_numbers(run, plain, kernel_name, on_card, reps, nb, flops,
                    dtype, atol=KERNEL_ATOL, rtol=KERNEL_RTOL, what=""):
    """Hold ``run()`` against ``plain()`` and time both: the numbers of one
    kernel variant."""
    got = run()
    want = plain()
    if on_card:
        import torch
        torch.cuda.synchronize()
    err, scaled = max_err(got, want, atol, rtol)
    require(scaled <= 1.0, f"{what}: max |err| {err:.3g} within atol={atol} "
            f"+ rtol={rtol}*|ref|")
    del got, want
    b_ms, b_by = bound_ms(nb, flops, dtype)
    ms, host_ms = cuda_ms(run, reps) if on_card else (None, None)
    prof_ms = profiled_ms(run, max(2, reps // 2), kernel_name) \
        if on_card else None
    plain_ms = cuda_ms(plain, 2)[0] if on_card else None
    return {"max_abs_err": err, "scaled_err": scaled, "ms": ms,
            "host_ms": host_ms, "profiler_ms": prof_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nb, "flops": flops}


def kernel_phases(mats, seed: int, device, reps: int = 20):
    """K1's two bodies and K2 against their plain versions at the main
    path's shapes: the direct body on NPB-C's lane-128 ELL, the staged body
    on NPB-C's layout as the CG path marshals it, K2 on HPCG's."""
    import torch
    from repro_torch.kernels.spmv_ell import kernel as K
    from repro_torch.kernels.spmv_ell import ops as O
    from repro_torch.kernels.spmv_ell import ref as R
    from repro_torch.sparse import ell_from_csr, ell_windows
    from repro_torch.sparse.formats import WINDOW

    rng = torch.Generator(device="cpu").manual_seed(seed + 1)
    on_card = device.type == "cuda"
    rows = []
    for name, kernels, (a, _) in (
            ("npb", ("spmv_ell", "spmv_ell_staged"), mats["npb"]),
            ("hpcg", ("spmv_ell_windowed",), mats["hpcg"])):
        ell = ell_from_csr(a, lane=128)
        vec = torch.randn(a.cols, generator=rng).to(device)
        bias = torch.randn(a.rows, generator=rng).to(device)
        csr_t = sparse_csr(a)
        library_ms = cuda_ms(lambda: csr_t @ vec, reps)[0] if on_card \
            else None
        # the yardstick computes the same function
        library_err = float((csr_t @ vec - R.spmv_ell_plain(
            ell.val, ell.col, vec, perm=ell.perm, out_rows=a.rows))
            .abs().max())
        del csr_t
        for kernel in kernels:
            if kernel == "spmv_ell":
                w = None
                ops = (ell.val, ell.col)
                run = lambda **kw: K.spmv_ell_cuda(ell.val, ell.col, vec, **kw)
                plain = lambda **kw: R.spmv_ell_plain(ell.val, ell.col, vec,
                                                      **kw)
            else:
                window = O.staged_window(a.cols, ell.val.element_size()) \
                    if kernel == "spmv_ell_staged" else WINDOW
                w = ell_windows(ell.val, ell.col, a.cols, window=window,
                                perm=ell.perm)
                ops = (w.val, w.col, w.seg_ptr, w.seg_window, w.seg_offset)
                wrapper = getattr(K, kernel + "_cuda")
                run = lambda **kw: wrapper(w, vec, **kw)
                plain = lambda **kw: R.spmv_ell_windowed_plain(w, vec, **kw)
            variants = {
                # as the CG path calls it: the store un-permutes the sort
                "main_path": dict(perm=ell.perm, out_rows=a.rows),
                "relu_bias": dict(bias=bias, epilogue="relu"),
                "silu": dict(epilogue="silu"),
            }
            entry = {"name": kernel, "matrix": name,
                     "shape": tuple(ops[0].shape),
                     "layout_bytes": nbytes(*ops), "variants": {},
                     "library_ms": library_ms, "library_err": library_err}
            if w is not None:
                entry.update(segments=w.n_segments, slabs=w.n_slabs,
                             windows=w.n_windows, window=w.window)
            for vname, kw in variants.items():
                io = nbytes(vec, kw.get("bias"), kw.get("perm"),
                            torch.empty(a.rows, device="meta"))
                # the stored entries, not the layout's padded slots, each
                # a value and a column id at the widths the layout stores
                nb = a.nnz * (ops[0].element_size()
                              + ops[1].element_size()) + io
                v = variant_numbers(lambda: run(**kw), lambda: plain(**kw),
                                    kernel + "_kernel", on_card, reps, nb,
                                    2 * a.nnz, a.val.dtype,
                                    what=f"{kernel}/{vname}")
                v["layout_bytes"] = nbytes(*ops) + io
                entry["variants"][vname] = v
            rows.append(entry)
            del w, ops, run, plain
        del ell
    return rows


def packed_tiles_of(a) -> dict:
    """What ``cuda.bcsr`` (``default_for cuda`` on SpMM) would marshal for
    the matrix ``a``: its packed 128x128 tiles, built and measured."""
    from repro_torch.sparse.convert import csr_to_packed_bcsr

    p = csr_to_packed_bcsr(a, (128, 128))
    return {"tiles": p.nblocks, "nnz": p.nnz, "bytes": layout_bytes(p),
            "dense_tile_bytes": p.nblocks * 128 * 128 * a.val.element_size()}


def check_layouts(rows) -> None:
    """K1's staged layout at NPB-C within 0.33 GB (its lane-128 ELL takes
    0.46 GB) and K2's at HPCG-104^3 within 0.31 GB (padding every row to
    all 18 windows would take 5.18 GB)."""
    limits = {"spmv_ell_staged": K1_LAYOUT_BYTES,
              "spmv_ell_windowed": K2_LAYOUT_BYTES}
    for e in rows:
        if e["name"] in limits:
            require(e["layout_bytes"] <= limits[e["name"]],
                    f"{e['name']}'s layout within {limits[e['name']]} B, "
                    f"got {e['layout_bytes']} B")


def sparse_csr(a):
    """``a`` as a torch sparse CSR tensor: the cuSPARSE yardstick."""
    import torch

    with warnings.catch_warnings():     # "beta state" notice
        warnings.simplefilter("ignore")
        return torch.sparse_csr_tensor(a.row_ptr.long(), a.col_ind.long(),
                                       a.val, size=a.shape,
                                       check_invariants=False)


# ---------------------------------------------------------------------------
# SpMM and SpMV on BCSR: K3
# ---------------------------------------------------------------------------

def spmm_path(a, seed: int, device, steps: int = GNN_STEPS,
              width: int = GNN_WIDTH):
    """The mesh-GNN aggregation: ``steps`` compiled steps of relu(A @ H +
    b), H rescaled between steps; then the same loop uncompiled."""
    import torch
    from repro_torch import lilac
    from repro_torch.kernels.bsr_spmm import kernel as B
    from repro_torch.sparse import BCSR, PackedBCSR

    gen = torch.Generator(device=device).manual_seed(seed + 2)
    h0 = torch.randn((a.cols, width), generator=gen, device=device)
    bias = torch.randn(width, generator=gen, device=device)
    fast = lilac.compile(gnn_step, mode="host", device=device)
    before = memory_mark(device)
    calls: list = []
    step = timed(fast, calls, device)
    t0 = time.perf_counter()
    B.reset_launches()
    h = h0
    for _ in range(steps):
        h = step(a.val, a.col_ind, a.row_ptr, h, bias)
        h = h / h.abs().max()
    sync(device)
    launches = dict(B.LAUNCHES)
    seconds = time.perf_counter() - t0
    peak, kept = memory_read(device, before)
    (m,) = fast.last_report.matches
    plan = fast.cache.plans.get(("csr_binding_mm", "BCSR128x128"))
    packed = marshaled(fast, PackedBCSR)
    res = {
        "packed": len(packed), "dense_tiles": len(marshaled(fast, BCSR)),
        "layout_bytes": packed and layout_bytes(packed[0]),
        "tiles": packed and packed[0].nblocks,
        "match": (m.computation, m.format, m.epilogue),
        "selections": [n for _, n in fast.last_selections],
        "repacks": fast.cache.stats.misses, "hits": fast.cache.stats.hits,
        "repack_seconds": plan and plan.build_seconds,
        "repack_path": plan and plan.last_path,
        "trace_seconds": fast.stats["trace_seconds"],
        "detect_seconds": fast.stats["detect_seconds"],
        "launches": launches, "seconds": seconds, "first_call_s": calls[0],
        "steady_call_ms": steady_ms(calls), "peak_bytes": peak,
        "kept_bytes": kept, "shape": tuple(h.shape),
        "finite": bool(torch.isfinite(h).all())}
    del fast
    release(device)
    before = memory_mark(device)
    h_ref = h0
    t0 = time.perf_counter()
    for _ in range(steps):
        h_ref = gnn_step(a.val, a.col_ind, a.row_ptr, h_ref, bias)
        h_ref = h_ref / h_ref.abs().max()
    sync(device)
    res["naive_seconds"] = time.perf_counter() - t0
    res["naive_peak_bytes"] = memory_read(device, before)[0]
    res["rel_to_naive"] = rel_l2(h, h_ref)
    return res


def check_spmm_path(res, steps: int = GNN_STEPS) -> None:
    require(res["match"] == ("spmm_csr", "CSR", "relu"),
            f"SpMM: one spmm_csr/CSR match with the relu-bias epilogue "
            f"fused, got {res['match']}")
    require(res["selections"] == ["cuda.bcsr"],
            f"SpMM: cuda.bcsr under the default policy, got "
            f"{res['selections']}")
    require(res["repacks"] == 1 and res["hits"] == steps - 1,
            f"SpMM: one repack and {steps - 1} hits, got {res['repacks']} "
            f"and {res['hits']}")
    require(res["repack_path"] == ("CSR", "BCSR128x128"),
            f"SpMM: the repack takes CSR -> BCSR128x128 directly, got "
            f"{res['repack_path']}")
    require(res["packed"] == 1 and res["dense_tiles"] == 0
            and res["layout_bytes"] <= K3_LAYOUT_BYTES,
            f"SpMM: the marshaled value is one packed-tile layout within "
            f"{K3_LAYOUT_BYTES} B and no dense tiles, got {res['packed']} "
            f"packed of {res['layout_bytes']} B, {res['dense_tiles']} dense")
    require(res["launches"] == {"bsr_spmm_wide": steps, "bsr_spmm_narrow": 0},
            f"K3's wide body launched once per SpMM step ({steps}), got "
            f"{res['launches']}")
    require(res["finite"], "SpMM: finite H")
    require(res["rel_to_naive"] <= GNN_RTOL,
            f"SpMM: |H - H_naive| / |H_naive| within {GNN_RTOL}, got "
            f"{res['rel_to_naive']:.3g}")


def bcsr_cg_path(a, b, x_ref, device, iters: int = CG_ITERS):
    """CG on the naive SpMV compiled with policy='cuda.bcsr'."""
    import torch
    from repro_torch import lilac
    from repro_torch.kernels.bsr_spmm import kernel as B

    fast = lilac.compile(naive_spmv, mode="host", policy="cuda.bcsr",
                         device=device)
    before = memory_mark(device)
    calls: list = []
    t0 = time.perf_counter()
    B.reset_launches()
    x = cg(timed(fast, calls, device), a, b, iters)
    sync(device)
    launches = dict(B.LAUNCHES)
    seconds = time.perf_counter() - t0
    peak, kept = memory_read(device, before)
    (m,) = fast.last_report.matches
    res = {"match": (m.computation, m.format),
           "selections": [n for _, n in fast.last_selections],
           "repacks": fast.cache.stats.misses, "hits": fast.cache.stats.hits,
           "repack_seconds": fast.cache.plans["csr_binding", "BCSR128x128"]
           .build_seconds,
           "launches": launches, "seconds": seconds,
           "first_call_s": calls[0], "steady_call_ms": steady_ms(calls),
           "peak_bytes": peak, "kept_bytes": kept,
           "finite": bool(torch.isfinite(x).all()),
           "rel_to_naive": rel_l2(x, x_ref)}
    del fast
    release(device)
    return res


def check_bcsr_cg(res, iters: int = CG_ITERS) -> None:
    require(res["match"] == ("spmv_csr", "CSR")
            and res["selections"] == ["cuda.bcsr"],
            f"BCSR CG: spmv_csr/CSR on cuda.bcsr, got {res['match']} "
            f"{res['selections']}")
    require(res["repacks"] == 1, f"BCSR CG: one repack, got {res['repacks']}")
    require(res["launches"] == {"bsr_spmm_wide": 0,
                                "bsr_spmm_narrow": iters + 1},
            f"K3's narrow body launched once per CG SpMV ({iters + 1}), got "
            f"{res['launches']}")
    require(res["finite"] and res["rel_to_naive"] <= CG_RTOL,
            f"BCSR CG: iterate within {CG_RTOL} of the naive CG, got "
            f"{res['rel_to_naive']:.3g}")


def bsr_kernel_phases(a, seed: int, device, reps: int = 5):
    """K3's two bodies against the plain version on the HPCG operator's
    packed 128x128 tiles: the wide body at the SpMM path's call, every
    epilogue with a row and a column bias, bf16 tiles and operand; the
    narrow body at the SpMV width N = 1.  Returns an entry per body."""
    import dataclasses

    import torch
    from repro_torch.kernels.bsr_spmm import kernel as B
    from repro_torch.kernels.bsr_spmm import ref as R
    from repro_torch.sparse.convert import csr_to_packed_bcsr

    on_card = device.type == "cuda"
    before = memory_mark(device)
    t0 = time.perf_counter()
    f32 = csr_to_packed_bcsr(a, (128, 128))
    sync(device)
    repack_s = time.perf_counter() - t0
    repack_peak = memory_read(device, before)[0]
    bf16 = dataclasses.replace(f32, val=f32.val.bfloat16())
    gen = torch.Generator(device=device).manual_seed(seed + 4)
    h = torch.randn((a.cols, GNN_WIDTH), generator=gen, device=device)
    vec = torch.randn((a.cols, 1), generator=gen, device=device)
    col_bias = torch.randn(GNN_WIDTH, generator=gen, device=device)
    row_bias = torch.randn(a.rows, generator=gen, device=device)
    bodies = {
        "bsr_spmm_wide": {
            # as the SpMM path calls it
            "main_path": (f32, h, dict(bias=col_bias, bias_kind="col",
                                       epilogue="relu")),
            "relu_row": (f32, h, dict(bias=row_bias, bias_kind="row",
                                      epilogue="relu")),
            "silu_col": (f32, h, dict(bias=col_bias, bias_kind="col",
                                      epilogue="silu")),
            "silu_row": (f32, h, dict(bias=row_bias, bias_kind="row",
                                      epilogue="silu")),
            "bias_col": (f32, h, dict(bias=col_bias, bias_kind="col",
                                      epilogue="none")),
            "bias_row": (f32, h, dict(bias=row_bias, bias_kind="row",
                                      epilogue="none")),
            "product": (f32, h, {}),
            "bf16": (bf16, h.bfloat16(), dict(bias=col_bias, bias_kind="col",
                                              epilogue="relu")),
        },
        "bsr_spmm_narrow": {
            # as the BCSR CG calls it
            "main_path": (f32, vec, {}),
            "relu_row": (f32, vec, dict(bias=row_bias, bias_kind="row",
                                        epilogue="relu")),
            "bf16": (bf16, vec.bfloat16(), {}),
        },
    }
    csr_t = sparse_csr(a)
    library = {"bsr_spmm_wide": lambda: csr_t @ h,
               "bsr_spmm_narrow": lambda: csr_t @ vec}
    entries = []
    for body, variants in bodies.items():
        entry = {"name": body, "matrix": "hpcg",
                 "tiles": f32.nblocks, "nnz": f32.nnz, "repack_s": repack_s,
                 "repack_peak_bytes": repack_peak,
                 "layout_bytes": layout_bytes(f32),
                 # what dense f32 tiles of the same structure would hold
                 "dense_tile_bytes": f32.nblocks * 128 * 128 * 4,
                 "variants": {}}
        for vname, (tiles, dense, kw) in variants.items():
            run = lambda: B.bsr_spmm_cuda(tiles, dense, out_rows=a.rows, **kw)
            plain = lambda: R.bsr_spmm_plain(tiles, dense, out_rows=a.rows,
                                             **kw)
            n = dense.shape[1]
            io = nbytes(dense, kw.get("bias")) + a.rows * n * 4
            # the stored entries at the widths stored: a value, a 16-bit id
            nb = tiles.nnz * (tiles.val.element_size() + 2) + io
            v = variant_numbers(run, plain, body + "_kernel", on_card, reps,
                                nb, 2 * tiles.nnz * n, tiles.val.dtype,
                                what=f"{body}/{vname}")
            v["layout_bytes"] = layout_bytes(tiles) + io
            # L2 reads of the operand: the wide body stages bk rows of 128
            # columns under every tile; the narrow one reads an operand row
            # per entry
            v["operand_l2_bytes"] = (
                tiles.nblocks * 128 * -(-n // 128) * 128
                * dense.element_size() if body == "bsr_spmm_wide"
                else tiles.nnz * n * dense.element_size())
            entry["variants"][vname] = v
        entry["library_ms"] = cuda_ms(library[body], reps)[0] \
            if on_card else None
        main = bodies[body]["main_path"]
        entry["library_err"] = float((library[body]() - R.bsr_spmm_plain(
            main[0], main[1], out_rows=a.rows)).abs().max())
        entries.append(entry)
    del bodies, bf16, f32, csr_t, library
    return entries


# ---------------------------------------------------------------------------
# MoE: K4
# ---------------------------------------------------------------------------

def moe_inputs(cfg, seed: int, device, batch: int = MOE_BATCH,
               seq: int = MOE_SEQ):
    import torch
    from repro_torch.models import layers as L

    gen = torch.Generator(device=device).manual_seed(seed + 3)
    spec = L.moe_spec(cfg.d_model, cfg.d_ff, cfg.moe_experts, cfg.param_dtype)
    p = L.moe_params(spec, gen)
    x = torch.randn((batch, seq, cfg.d_model), generator=gen,
                    device=device).to(cfg.param_dtype)
    return p, x


def moe_path(cfg, p, x, device):
    """One expert layer through moe_block(impl='lilac'), then the naive
    block, each against the f32 plain oracle."""
    import torch
    from repro_torch.kernels.moe_gmm import kernel as G
    from repro_torch.kernels.moe_gmm import ref as GR
    from repro_torch.models import layers as L

    before = memory_mark(device)
    sync(device)
    t0 = time.perf_counter()
    G.reset_launches()
    out, _ = L.moe_block(p, x, topk=cfg.moe_topk, impl="lilac")
    sync(device)
    launches = G.LAUNCHES["gmm"]
    first_s = time.perf_counter() - t0
    peak, _ = memory_read(device, before)
    fast = L._lilac_moe_2d(device.type)
    (m,) = fast.last_report.matches
    res = {"match": (m.computation, m.format),
           "selections": [n for _, n in fast.last_selections],
           "traces": fast.stats["traces"],
           "trace_seconds": fast.stats["trace_seconds"],
           "detect_seconds": fast.stats["detect_seconds"],
           "launches": launches, "first_call_s": first_s, "peak_bytes": peak,
           "shape": tuple(out.shape), "dtype": str(out.dtype),
           "finite": bool(torch.isfinite(out).all())}
    calls: list = []
    for _ in range(3):
        timed(lambda: L.moe_block(p, x, topk=cfg.moe_topk, impl="lilac"),
              calls, device)()
    res["steady_call_ms"] = 1e3 * sorted(calls)[1]
    calls = []
    for _ in range(3):
        naive = timed(lambda: L.moe_block(p, x, topk=cfg.moe_topk,
                                          impl="naive"), calls, device)()[0]
    res["naive_call_ms"] = 1e3 * sorted(calls)[1]
    gate, idx, _ = L.moe_router(p, x, cfg.moe_topk)
    ref = torch.stack([GR.moe_ffn_ref(x[b], gate[b], idx[b], p["wg"],
                                      p["wu"], p["wd"])
                       for b in range(x.shape[0])])
    res["rel_l2"] = rel_l2(out, ref)
    res["naive_rel_l2"] = rel_l2(naive, ref)
    res["rel_to_naive"] = rel_l2(out, naive)
    return res


def check_moe_path(res, batch: int = MOE_BATCH) -> None:
    require(res["match"] == ("moe_ffn", "MOE"),
            f"MoE: one moe_ffn/MOE match, got {res['match']}")
    require(res["traces"] == 1, f"MoE: one trace for {batch} sequences, got "
            f"{res['traces']}")
    require(res["selections"] == ["cuda.gmm"],
            f"MoE: cuda.gmm under the default policy, got "
            f"{res['selections']}")
    require(res["launches"] == 3 * batch,
            f"K4 launched 3 times a sequence ({3 * batch}), got "
            f"{res['launches']}")
    require(res["finite"], "MoE: finite output")
    require(res["rel_l2"] <= MOE_RTOL and res["naive_rel_l2"] <= MOE_RTOL,
            f"MoE: relative L2 error against the f32 oracle within "
            f"{MOE_RTOL}, got {res['rel_l2']:.3g} (routed) and "
            f"{res['naive_rel_l2']:.3g} (naive)")


def gmm_kernel_phases(cfg, p, x, device, reps: int = 10):
    """K4 against its plain version at the MoE path's calls (the first
    sequence's routing): gate/up and down in bf16, gate/up in f32."""
    import torch
    from repro_torch.kernels.moe_gmm import kernel as G
    from repro_torch.kernels.moe_gmm import ref as GR
    from repro_torch.kernels.moe_gmm.ops import _route
    from repro_torch.models import layers as L

    on_card = device.type == "cuda"
    gate, idx, _ = L.moe_router(p, x[:1], cfg.moe_topk)
    T, K = idx.shape[1:]
    E, D, F = p["wg"].shape
    tm = 128
    dest, te, tp = _route(idx[0], T, K, E, tm)
    xs = torch.zeros((tp, D), dtype=x.dtype, device=device)
    xs[dest] = x[0].repeat_interleave(K, dim=0)
    g = G.gmm_cuda(xs, p["wg"], te, tm)
    u = G.gmm_cuda(xs, p["wu"], te, tm)
    hs = (torch.nn.functional.silu(g) * u).to(x.dtype)
    del g, u
    routed = T * K
    calls = {
        "gate_up": (xs, p["wg"]),
        "down": (hs, p["wd"]),
        "gate_up_f32": (xs.float(), p["wg"].float()),
    }
    entry = {"name": "gmm", "shape": {k: (tuple(a.shape), tuple(w.shape))
                                      for k, (a, w) in calls.items()},
             "tp": tp, "routed_rows": routed, "variants": {}}
    for vname, (a, w) in calls.items():
        fin, fout = w.shape[1:]
        run = lambda: G.gmm_cuda(a, w, te, tm)
        plain = lambda: GR.gmm_ref(a, w, te, tm)
        # the routed rows, not the padded Tp
        nb = routed * fin * a.element_size() + nbytes(w) + routed * fout * 4
        v = entry["variants"][vname] = variant_numbers(
            run, plain, "gmm_tc_kernel" if a.dtype == torch.bfloat16
            else "gmm_simt_kernel", on_card, reps, nb,
            2 * routed * fin * fout, a.dtype, GMM_ATOL, GMM_RTOL,
            what=f"gmm/{vname}")
        if v["ms"] is not None:
            # achieved rates over the routed rows and over all Tp rows
            v["tflops_routed"] = v["flops"] / v["ms"] / 1e9
            v["tflops_padded"] = 2 * tp * fin * fout / v["ms"] / 1e9
        if on_card and a.dtype == torch.bfloat16:
            v["witness"] = gmm_witnesses(a, w, te, tm)
    # the same grouped product in one PyTorch call, where this PyTorch has
    # one: torch._grouped_mm over each expert's aligned rows (the output in
    # bf16, as that call requires, where K4 writes f32)
    grouped = getattr(torch, "_grouped_mm", None)
    entry["library_ms"] = entry["library_err"] = None
    if on_card and grouped is not None:
        counts = torch.bincount(idx[0].reshape(-1).long(), minlength=E)
        offs = torch.cumsum((counts + tm - 1) // tm * tm, 0).to(torch.int32)
        rows = int(offs[-1])
        lib = lambda: grouped(xs, p["wg"], offs=offs)
        entry["library_err"] = float((lib()[:rows].float() - GR.gmm_ref(
            xs, p["wg"], te, tm)[:rows]).abs().max())
        entry["library_ms"] = cuda_ms(lib, reps)[0]
    # a GEMM-rate yardstick, not the same function: one expert's weights
    # for all routed rows, the same flops as the gate/up call
    x2, w0 = xs[:routed], p["wg"][0]
    entry["gemm_ms"] = cuda_ms(lambda: torch.matmul(x2, w0), reps)[0] \
        if on_card else None
    return entry


def gmm_witnesses(a, w, te, tm) -> dict:
    """Two other products of the same bf16 operands, each held against
    ``gmm_ref`` as K4 is: K4's f32 body (exact products, f32 FMAs summed in
    its own order, no tensor cores) and cuBLAS's bf16 tensor-core GEMM with
    an f32 output, one call per expert.  If cuBLAS errs as K4 does, K4's
    error is the tensor cores' accumulation, not a fault of its pipeline.
    ``terms_max`` is the largest sum of |products| of an output, the scale
    that the rounding of the sums works on."""
    import torch
    from repro_torch.kernels.moe_gmm import kernel as G
    from repro_torch.kernels.moe_gmm import ref as GR

    want = GR.gmm_ref(a, w, te, tm)
    k4 = G.gmm_cuda(a, w, te, tm)
    simt = G.gmm_cuda(a.float(), w.float(), te, tm)
    row_e = te.long().repeat_interleave(tm)[:a.shape[0]]
    try:
        lib = torch.zeros_like(want)
        for e in torch.unique(row_e).tolist():
            rows = torch.nonzero(row_e == e).reshape(-1)
            lib[rows] = torch.mm(a[rows], w[e], out_dtype=torch.float32)
        cublas_err = float((lib - want).abs().max())
        k4_vs_cublas = float((k4 - lib).abs().max())
    except (RuntimeError, TypeError, NotImplementedError):
        cublas_err = k4_vs_cublas = None   # no bf16 -> f32 mm here
    return {"k4_err": float((k4 - want).abs().max()),
            "f32_simt_err": float((simt - want).abs().max()),
            "cublas_bf16_f32_err": cublas_err, "k4_vs_cublas": k4_vs_cublas,
            "ref_max": float(want.abs().max()),
            "terms_max": float(GR.gmm_ref(a.abs(), w.abs(), te, tm).max())}


# ---------------------------------------------------------------------------

def sass_count(library: Path, opcode: str) -> int:
    """How many SASS instructions of ``opcode`` the library holds
    (cuobjdump of the CUDA toolkit)."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(library)], check=True,
                          capture_output=True, text=True).stdout
    return sum(opcode in line for line in sass.splitlines())


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


REPLACES = {      # kernel body -> the TPU kernel it replaces
    "spmv_ell_staged": "src/repro/kernels/spmv_ell/kernel.py:57",
    "spmv_ell": "src/repro/kernels/spmv_ell/kernel.py:57",
    "spmv_ell_windowed": "src/repro/kernels/spmv_ell/kernel.py:125",
    "bsr_spmm_wide": "src/repro/kernels/bsr_spmm/kernel.py:81",
    "bsr_spmm_narrow": "src/repro/kernels/bsr_spmm/kernel.py:81",
    "gmm": "src/repro/kernels/moe_gmm/kernel.py:53",
}
SOURCES = {
    "spmv_ell_staged": "src/repro_torch/kernels/spmv_ell/csrc/spmv_ell.cu",
    "spmv_ell": "src/repro_torch/kernels/spmv_ell/csrc/spmv_ell.cu",
    "spmv_ell_windowed": "src/repro_torch/kernels/spmv_ell/csrc/spmv_ell.cu",
    "bsr_spmm_wide": "src/repro_torch/kernels/bsr_spmm/csrc/bsr_spmm.cu",
    "bsr_spmm_narrow": "src/repro_torch/kernels/bsr_spmm/csrc/bsr_spmm.cu",
    "gmm": "src/repro_torch/kernels/moe_gmm/csrc/moe_gmm.cu",
}


def kernel_entry(e, main: str, launches: int):
    m = e["variants"][main]
    return {"name": e["name"], "route": "cuda", "source": SOURCES[e["name"]],
            "replaces": REPLACES[e["name"]], "launches": launches,
            "max_abs_err": max(v["max_abs_err"]
                               for v in e["variants"].values()),
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": e["library_ms"]}


def print_variants(e, tol: str) -> None:
    for vname, v in e["variants"].items():
        print(f"{e['name']} {vname}: max|err| {v['max_abs_err']:.3g} "
              f"({tol}), {v['ms']:.4f} ms (host {v['host_ms']:.4f} ms to "
              f"enqueue; profiler {v['profiler_ms']} ms a launch), plain "
              f"{v['plain_ms']:.4f} ms, bound {v['bound_ms']:.4f} ms "
              f"({v['bound_by']}: {v['bytes']} B, {v['flops']} flops)"
              + (f"; the layout moves {v['layout_bytes']} B"
                 if "layout_bytes" in v else "")
              + (f"; {v['operand_l2_bytes']} B of operand reads from L2"
                 if "operand_l2_bytes" in v else "")
              + (f"; {v['tflops_routed']:.1f} TFLOP/s over the routed rows, "
                 f"{v['tflops_padded']:.1f} over all Tp rows"
                 if "tflops_routed" in v else ""))


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
    # full-f32 products in the plain versions and the oracles
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = smi_line()
    print(f"card: {smi}")
    device = torch.device("cuda")

    from repro_torch.configs.olmoe_1b_7b import CONFIG as OLMOE
    from repro_torch.kernels import build
    from repro_torch.kernels.bsr_spmm import kernel as B
    from repro_torch.kernels.moe_gmm import kernel as G
    from repro_torch.kernels.spmv_ell import kernel as K

    sources = [K.SOURCE, B.SOURCE, G.SOURCE]
    t0 = time.perf_counter()
    build.build_all(sources)
    print(f"built {', '.join(str(s.relative_to(ROOT)) for s in sources)} "
          f"in {time.perf_counter() - t0:.1f}s")
    for s in sources:
        for line in build.build_log(s).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas: {line.strip()}")
    hgmma = sass_count(build.library_path(G.SOURCE), "HGMMA")
    print(f"{G.SOURCE.name}: {hgmma} HGMMA instructions in its SASS")
    require(hgmma > 0, "K4's bf16 body runs on the tensor cores (HGMMA)")

    record = {"card": smi}
    t0 = time.perf_counter()
    mats = matrices(args.seed, device)
    for name, (a, _) in mats.items():
        print(f"matrix {name}: {a.rows} rows, {a.nnz} stored entries")
    print(f"generated in {time.perf_counter() - t0:.1f}s")

    # -- SpMV on ELL (K1, K2) ------------------------------------------------
    res = main_path(mats, args.seed, device)
    x_ref = res.pop("x_ref")["hpcg"]
    for name in mats:
        r = res[name]
        print(f"SpMV path {name}: match {r['match']} via {r['selections']}, "
              f"traced in {r['trace_seconds']:.2f}s, detected in "
              f"{r['detect_seconds']:.2f}s, "
              f"{r['repacks']} repack ({r['repack_seconds']:.2f}s), "
              f"{r['hits']} hits; CG {CG_ITERS} it in {r['seconds']:.2f}s "
              f"(first call {r['first_call_s']:.2f}s, then "
              f"{r['steady_call_ms']:.3f} ms a call), "
              f"|x-x_naive|/|x_naive| = {r['rel_to_naive']:.3g} "
              f"(tol {CG_RTOL}), residual {r['residual']:.3g}, peak "
              f"{r['peak_bytes'] / 2**30:.2f} GiB, kept after the CG "
              f"{r['kept_bytes'] / 2**30:.2f} GiB; marshaled layout "
              f"{r['layout_bytes']} B in {r['windows']} windows of "
              f"{r['window']}")
    print(f"SpMV path ELL layer: {res['ell_layer']}")
    print(f"launches on the SpMV paths: {res['launches']}")
    check_main_path(res)
    record["spmv_path"] = res
    ell_rows = kernel_phases(mats, args.seed, device)
    for e in ell_rows:
        print(f"{e['name']} layout {e['shape']}: {e['layout_bytes']} B"
              + (f", {e['segments']} segments over {e['slabs']} slabs "
                 f"({e['segments'] / e['slabs']:.3f} a slab) of "
                 f"{e['windows']} windows of {e['window']}"
                 if "segments" in e else ""))
        print_variants(e, f"tol atol={KERNEL_ATOL} + rtol={KERNEL_RTOL}*|ref|")
        print(f"{e['name']} library (cuSPARSE CSR SpMV): "
              f"{e['library_ms']:.4f} ms, max|err| vs plain "
              f"{e['library_err']:.3g}")
    check_layouts(ell_rows)
    kernels = [kernel_entry(e, "main_path", res["launches"][e["name"]])
               for e in ell_rows]
    record["kernels"] = ell_rows
    record["npb_packed_tiles"] = t = packed_tiles_of(mats["npb"][0])
    print(f"npb in cuda.bcsr's packed 128x128 tiles: {t['tiles']} tiles, "
          f"{t['nnz']} entries, {t['bytes']} B (dense f32 tiles would take "
          f"{t['dense_tile_bytes']} B)")
    a_hpcg, b_hpcg = mats.pop("hpcg")
    del mats
    release(device)

    # -- SpMM and SpMV on BCSR (K3) -----------------------------------------
    spmm = spmm_path(a_hpcg, args.seed, device)
    print(f"SpMM path hpcg x {GNN_WIDTH}: match {spmm['match']} via "
          f"{spmm['selections']}, traced in {spmm['trace_seconds']:.2f}s, "
          f"detected in {spmm['detect_seconds']:.2f}s, {spmm['repacks']} "
          f"repack {spmm['repack_path']} ({spmm['repack_seconds']:.2f}s), "
          f"{spmm['hits']} hits; {GNN_STEPS} steps in {spmm['seconds']:.2f}s "
          f"(first call {spmm['first_call_s']:.2f}s, then "
          f"{spmm['steady_call_ms']:.3f} ms a call); naive loop "
          f"{spmm['naive_seconds']:.2f}s; |H-H_naive|/|H_naive| = "
          f"{spmm['rel_to_naive']:.3g} (tol {GNN_RTOL}); peak "
          f"{spmm['peak_bytes'] / 2**30:.2f} GiB (naive "
          f"{spmm['naive_peak_bytes'] / 2**30:.2f} GiB), kept "
          f"{spmm['kept_bytes'] / 2**30:.2f} GiB; marshaled "
          f"{spmm['packed']} packed layout of {spmm['tiles']} tiles, "
          f"{spmm['layout_bytes']} B ({spmm['dense_tiles']} dense); K3 "
          f"launches {spmm['launches']}")
    check_spmm_path(spmm)
    release(device)
    bcg = bcsr_cg_path(a_hpcg, b_hpcg, x_ref, device)
    print(f"BCSR SpMV path hpcg: match {bcg['match']} via "
          f"{bcg['selections']}, {bcg['repacks']} repack "
          f"({bcg['repack_seconds']:.2f}s), {bcg['hits']} hits; CG "
          f"{CG_ITERS} it in {bcg['seconds']:.2f}s (first call "
          f"{bcg['first_call_s']:.2f}s, then {bcg['steady_call_ms']:.3f} ms a "
          f"call), |x-x_naive|/|x_naive| = {bcg['rel_to_naive']:.3g} (tol "
          f"{CG_RTOL}); peak {bcg['peak_bytes'] / 2**30:.2f} GiB; K3 "
          f"launches {bcg['launches']}")
    check_bcsr_cg(bcg)
    record.update(spmm_path=spmm, bcsr_cg_path=bcg)
    bsr = bsr_kernel_phases(a_hpcg, args.seed, device)
    for e in bsr:
        print(f"{e['name']}: {e['tiles']} packed tiles, {e['nnz']} entries, "
              f"{e['layout_bytes']} B (dense f32 tiles would take "
              f"{e['dense_tile_bytes']} B), repacked in {e['repack_s']:.2f}s "
              f"at a peak of {e['repack_peak_bytes'] / 2**30:.2f} GiB")
        print_variants(e, f"tol atol={KERNEL_ATOL} + rtol={KERNEL_RTOL}*|ref|")
        print(f"{e['name']} library (cuSPARSE CSR "
              f"{'SpMM' if e['name'] == 'bsr_spmm_wide' else 'SpMV'}): "
              f"{e['library_ms']:.4f} ms, max|err| vs plain "
              f"{e['library_err']:.3g}")
        kernels.append(kernel_entry(
            e, "main_path", (spmm if e["name"] == "bsr_spmm_wide"
                             else bcg)["launches"][e["name"]]))
    del a_hpcg, b_hpcg, x_ref
    release(device)

    # -- MoE (K4) ------------------------------------------------------------
    p, x = moe_inputs(OLMOE, args.seed, device)
    moe = moe_path(OLMOE, p, x, device)
    print(f"MoE path {OLMOE.name} x {tuple(x.shape)} {x.dtype}: match "
          f"{moe['match']} via {moe['selections']}, {moe['traces']} trace "
          f"({moe['trace_seconds']:.2f}s), detected in "
          f"{moe['detect_seconds']:.2f}s; first call "
          f"{moe['first_call_s']:.2f}s, then {moe['steady_call_ms']:.3f} ms "
          f"a block (naive {moe['naive_call_ms']:.3f} ms); relative L2 "
          f"error vs the f32 oracle {moe['rel_l2']:.3g} (naive bf16 "
          f"{moe['naive_rel_l2']:.3g}; tol {MOE_RTOL}), vs naive "
          f"{moe['rel_to_naive']:.3g}; peak {moe['peak_bytes'] / 2**30:.2f} "
          f"GiB; K4 launches {moe['launches']}")
    check_moe_path(moe)
    record["moe_path"] = moe
    gmm = gmm_kernel_phases(OLMOE, p, x, device)
    print(f"gmm Tp {gmm['tp']} rows for {gmm['routed_rows']} routed")
    print_variants(gmm, f"tol atol={GMM_ATOL} + rtol={GMM_RTOL}*|ref|")
    print(f"gmm library (torch._grouped_mm, the gate/up product with a "
          f"bf16 output): {gmm['library_ms']} ms, max|err| vs plain "
          f"{gmm['library_err']}; GEMM-rate yardstick (one torch.matmul of "
          f"({gmm['routed_rows']}, {OLMOE.d_model}) x ({OLMOE.d_model}, "
          f"{OLMOE.d_ff}) bf16, not the same function): "
          f"{gmm['gemm_ms']:.4f} ms")
    for vname, v in gmm["variants"].items():
        if "witness" in v:
            print(f"gmm/{vname} witnesses, max|err| vs plain: {v['witness']}")
    kernels.append(kernel_entry(gmm, "gate_up", moe["launches"]))
    record["kernels"] += bsr + [gmm]

    if args.record is not None:
        args.record.parent.mkdir(parents=True, exist_ok=True)
        record["seconds"] = time.perf_counter() - t_start
        args.record.write_text(json.dumps(record, indent=1, default=str))
    print(f"total {time.perf_counter() - t_start:.1f}s")
    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
