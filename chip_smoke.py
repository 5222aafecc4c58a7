#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--record PATH]

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit.  It imports nothing of JAX or of the JAX package, and:

1. prints the card's name and power limit (nvidia-smi);
2. builds every CUDA kernel of the port from the sources in the checkout
   (one nvcc per source, all started together), prints ptxas's registers
   and shared memory, and checks with cuobjdump, function by function,
   that K4's bf16 body runs on the tensor cores (HGMMA in its SASS) and
   its f32 body on the CUDA cores (FFMA, no HMMA or HGMMA), printing the
   f32 body's 128-bit and 32-bit shared-memory loads;
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
     tile's entries only: at most 0.25 GB, no dense tile) and 14 hits of
     the plan or the data plane, 15
     launches of K3's wide body, and the final H against the same loop on
     the uncompiled naive SpMM;
   * SpMV on BCSR (K3 at N = 1): 25 CG iterations on the HPCG operator
     with policy="cuda.bcsr": 26 launches of K3's narrow body, one
     repack, the CG check;
   * MoE (K4): one OLMoE-1B-7B expert layer (d_model 2048, 64 experts of
     d_ff 1024, top-8, bf16; seeded weights) over two sequences of 4,096
     tokens through moe_block(impl="lilac") — trace mode, as the reference
     compiles it — under the default policy: one moe_ffn/MOE match traced
     once, cuda.gmm as the custom op lilac_torch::moe_ffn, 6 launches (3 a
     sequence), and the output and the naive bf16 block's, each as
     relative L2 error against the f32 plain oracle on the same bf16
     inputs;
   * MoE in f32 (K4's f32 body): one sequence of 4,096 tokens of the
     same layer with its parameters and input cast to f32 through
     moe_block(impl="lilac"): cuda.gmm, 3 launches of the f32 body and
     none of the bf16 one, and the output and the naive f32 block's
     against the f32 plain oracle (relative L2 error within 1e-4), with
     the block's time beside the naive block's;
   * the autotuner: lilac.compile(naive SpMV, mode="host",
     policy="autotune") at NPB-C and at HPCG on a fresh store in a
     temporary directory: each candidate's steady time, repack seconds and
     amortized cost (a candidate that cannot fit is eliminated by its
     exception), the winner checked to have the least amortized cost, the
     25 CG iterations through it with the iterate check; then a second
     process on the same store (its plan cache off) must re-time nothing
     and pick the same winners;
   * executable plans: the NPB-C and HPCG CGs on cuda.ell (K1 staged,
     K2) and the HPCG CG on cuda.bcsr (K3 narrow), 25 iterations each,
     with bake=True (the default: the call's program replayed from one
     CUDA graph after the first call) and bake=False (the interpreter):
     the steady call, one call's device and host-enqueue ms, plan_info,
     the repack and the launches (26 a CG in both), the iterates equal bit
     for bit, and an in-place val.mul_(2) between two calls re-marshaling
     to the naive result; then a second process on the same plans.json
     and an empty tuner store must detect nothing, time nothing, select
     the same harnesses and bake; and A @ (A @ b) at HPCG under
     policy="autotune" on the autotune phase's store: two coupled matches,
     the joint plan search run once, its assignment no dearer than
     greedy's, the entry baked, the output against the uncompiled one.
     Every path above and below bakes too
     (the default), so its launch counts include CUDA-graph replays;
   * trace mode: the ELL layer (K1's direct body, fused epilogue, as the
     custom op lilac_torch::spmv_ell) and one sequence of the OLMoE layer
     compiled with the default mode: one custom-op node in the rewritten
     graph, the output equal to host mode's bit for bit, the graph
     captured in a torch.cuda.CUDAGraph and replayed equal to the eager
     call, with the per-call times of host mode, trace mode, the graph and
     the replay; and policy="autotune" in trace mode on the MoE layer,
     sweeping cuda.gmm's tm;
   every path above injects no fault and must show no containment event
   and no quarantine skip (each one warns) and leave the quarantine store,
   kept in the run's temporary directory, empty; then
   * containment, on the same matrices and layer: kernel_raise:cuda.ell on
     the NPB-C CG (policy="cuda.ell", baked): the 25 iterates within 1e-3
     of the naive CG, one record (spmv_csr, cuda.ell, default) on disk and
     the fallback named, a new function skipping cuda.ell with no
     containment event but a warned, counted quarantine skip,
     and with the store cleared cuda.ell and K1 staged back (26 launches);
     nan_output:cuda.bcsr on 3 GNN steps: the NaN caught, the output
     within 1e-4 of the naive loop; shadow checks at rate 1 on the NPB-C
     CG's 25 plan calls (f32 tolerance) and on two MoE blocks (bf16
     tolerance) with no divergence, and shadow_diverge:dispatch on the
     BCSR CG: the naive answer served, the plan torn down, cuda.bcsr
     quarantined and the next call without it; the combined fault spec of
     tools/chaos_smoke_torch.py under policy="autotune" at NPB-C and HPCG
     (seeded by --seed; zero uncontained exceptions, results equal to the
     uncompiled program's, quarantines persisted); and the fault-free plan
     and bake=False CG calls beside those of commit 199bd38;
4. holds each kernel against its plain torch version at the paths' shapes
   (every fused epilogue; f32 and bf16 for K3 and K4; K1's direct body
   at every rows_per_slab of SLAB_PROBE, at NPB-C and at SMALL_ROWS rows,
   and K4 at every tm cuda.gmm declares, each bit for bit against the
   default; K4's f32 body at the OLMoE gate/up shapes too) and times the
   kernel (CUDA events, host enqueue, torch.profiler), the plain version
   and one PyTorch call of the same function that the port never calls
   (cuSPARSE SpMV and SpMM, torch._grouped_mm in bf16 and on the f32
   operands; for K4 also a bf16 GEMM of the same flops as a rate
   yardstick), beside the least time the card
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
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
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
# the same layer in f32 (no TF32 anywhere): the routed path and the oracle
# differ only in the order of f32 sums of 2,048 and 1,024 products and of
# each token's 8 gated terms, a rounding of ~2^-24 a step: ~1e-6 relative
MOE_F32_RTOL = 1e-4
KERNEL_ATOL = KERNEL_RTOL = 1e-4   # K1-K3 against their plain versions
# K4: f32 sums of 1,024 or 2,048 products, in another order than cuBLAS's
GMM_ATOL = GMM_RTOL = 1e-3
K1_LAYOUT_BYTES = 0.33e9       # K1's staged layout at NPB-C
K2_LAYOUT_BYTES = 0.31e9       # K2's compacted layout at HPCG-104^3
K3_LAYOUT_BYTES = 0.25e9       # K3's packed tiles at HPCG-104^3
# K1's direct body: rows_per_slab values timed, declared or not, at NPB-C
# and at its first SMALL_ROWS rows (128 slabs of the default size, fewer
# than the card's 132 SMs): the tune clause keeps the values that win
SLAB_PROBE = (32, 8, 64, 128)
SMALL_ROWS = 4096


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
        "plan_hits": fast.plan_info()["plan_hits"],
        "plan": {k: d[k] for d in fast.plan_info()["plans"][:1]
                 for k in ("cuda_graph", "graph_copy_bytes", "replay_ms",
                           "eager_ms")},
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
    require(res["repacks"] == 1
            and res["hits"] + res["plan_hits"] == steps - 1,
            f"SpMM: one repack and {steps - 1} hits of the plan or the data "
            f"plane, got {res['repacks']}, {res['plan_hits']} and "
            f"{res['hits']}")
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
    block, each against the f32 plain oracle; ``launches`` counts each K4
    body's launches in the first call."""
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
    launches = dict(G.LAUNCHES)
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
    require(res["launches"] == {"gmm": 3 * batch, "gmm_f32": 0},
            f"K4's bf16 body launched 3 times a sequence ({3 * batch}), "
            f"got {res['launches']}")
    require(res["finite"], "MoE: finite output")
    require(res["rel_l2"] <= MOE_RTOL and res["naive_rel_l2"] <= MOE_RTOL,
            f"MoE: relative L2 error against the f32 oracle within "
            f"{MOE_RTOL}, got {res['rel_l2']:.3g} (routed) and "
            f"{res['naive_rel_l2']:.3g} (naive)")


def moe_f32_path(cfg, p, x, device):
    """The first sequence of the expert layer with its parameters and input
    cast to f32 (K4's f32 body), as moe_path runs it."""
    return moe_path(cfg, {k: v.float() for k, v in p.items()},
                    x[:1].float(), device)


def check_moe_f32_path(res) -> None:
    require(res["selections"] == ["cuda.gmm"],
            f"MoE f32: cuda.gmm under the default policy, got "
            f"{res['selections']}")
    require(res["launches"] == {"gmm": 0, "gmm_f32": 3},
            f"MoE f32: 3 launches of K4's f32 body and none of the bf16 "
            f"one, got {res['launches']}")
    require(res["finite"] and res["dtype"] == "torch.float32",
            f"MoE f32: a finite f32 output, got {res['dtype']}")
    require(res["rel_l2"] <= MOE_F32_RTOL
            and res["naive_rel_l2"] <= MOE_F32_RTOL,
            f"MoE f32: relative L2 error against the f32 oracle within "
            f"{MOE_F32_RTOL}, got {res['rel_l2']:.3g} (routed) and "
            f"{res['naive_rel_l2']:.3g} (naive)")


def gmm_kernel_phases(cfg, p, x, device, reps: int = 10):
    """K4 against its plain version at the MoE path's calls (the first
    sequence's routing): the bf16 body at gate/up and down, the f32 body
    at gate/up on the operands cast to f32.  Two entries: ``gmm`` (bf16)
    and ``gmm_f32``."""
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
    entry32 = {"name": "gmm_f32", "tp": tp, "routed_rows": routed,
               "variants": {}}
    for vname, (a, w) in calls.items():
        fin, fout = w.shape[1:]
        run = lambda: G.gmm_cuda(a, w, te, tm)
        plain = lambda: GR.gmm_ref(a, w, te, tm)
        # the routed rows, not the padded Tp
        nb = routed * fin * a.element_size() + nbytes(w) + routed * fout * 4
        bf16 = a.dtype == torch.bfloat16
        v = (entry if bf16 else entry32)["variants"][vname] = \
            variant_numbers(run, plain, "gmm_tc_kernel" if bf16
                            else "gmm_simt_kernel", on_card, reps, nb,
                            2 * routed * fin * fout, a.dtype, GMM_ATOL,
                            GMM_RTOL, what=f"gmm/{vname}")
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
    entry32["library_ms"] = entry32["library_err"] = None
    if on_card and grouped is not None:
        counts = torch.bincount(idx[0].reshape(-1).long(), minlength=E)
        offs = torch.cumsum((counts + tm - 1) // tm * tm, 0).to(torch.int32)
        rows = int(offs[-1])
        lib = lambda: grouped(xs, p["wg"], offs=offs)
        entry["library_err"] = float((lib()[:rows].float() - GR.gmm_ref(
            xs, p["wg"], te, tm)[:rows]).abs().max())
        entry["library_ms"] = cuda_ms(lib, reps)[0]
        # the f32 body's product as one call (this PyTorch takes f32 and
        # computes it in full f32: max |err| ~1e-5)
        xf, wf = calls["gate_up_f32"]
        lib32 = lambda: grouped(xf, wf, offs=offs)
        entry32["library_err"] = float((lib32()[:rows] - GR.gmm_ref(
            xf, wf, te, tm)[:rows]).abs().max())
        entry32["library_ms"] = cuda_ms(lib32, reps)[0]
    # a GEMM-rate yardstick, not the same function: one expert's weights
    # for all routed rows, the same flops as the gate/up call
    x2, w0 = xs[:routed], p["wg"][0]
    entry["gemm_ms"] = cuda_ms(lambda: torch.matmul(x2, w0), reps)[0] \
        if on_card else None
    return entry, entry32


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
# The autotuner (host mode) and trace mode
# ---------------------------------------------------------------------------

def _kernel_of(winner: str, a) -> dict:
    """The kernel body a spmv_csr harness launches on ``a`` (none for the
    plain torch.* harnesses)."""
    from repro_torch.kernels.spmv_ell.ops import RESIDENT_VEC_LIMIT

    if winner == "cuda.ell":
        return "spmv_ell_staged" if a.cols <= RESIDENT_VEC_LIMIT \
            else "spmv_ell_windowed"
    return {"cuda.bcsr": "bsr_spmm_narrow"}.get(winner)


def autotune_path(mats, x_refs, device, iters: int = CG_ITERS):
    """lilac.compile(naive_spmv, mode="host", policy="autotune") at each
    matrix on the store LILAC_TORCH_AUTOTUNE_CACHE names: the first call
    measures every candidate (a candidate that raises is eliminated), the
    CG then runs through the winner."""
    import torch
    from repro_torch import lilac
    from repro_torch.core.harness import REGISTRY
    from repro_torch.kernels.bsr_spmm import kernel as B
    from repro_torch.kernels.spmv_ell import kernel as K

    out = {}
    for name, (a, b) in mats.items():
        fast = lilac.compile(naive_spmv, mode="host", policy="autotune",
                             device=device)
        tuner = REGISTRY.autotuner
        timed_before = tuner.stats.timing_calls
        sync(device)
        t0 = time.perf_counter()
        fast(a.val, a.col_ind, a.row_ptr, b)
        sync(device)
        tune_s = time.perf_counter() - t0
        report = dict(tuner.last_report)
        rec = tuner.cache.entries[tuner.last_decision.sig]["host"]
        K.reset_launches()
        B.reset_launches()
        calls: list = []
        x = cg(timed(fast, calls, device), a, b, iters)
        sync(device)
        launches = {**K.LAUNCHES, **B.LAUNCHES}
        out[name] = {
            "winner": fast.last_selections[0][1], "record": rec,
            "candidates": report, "tune_seconds": tune_s,
            "timing_calls": tuner.stats.timing_calls - timed_before,
            "eliminated": sorted(n for n, r in report.items() if r is None),
            "launches": launches, "kernel": _kernel_of(rec["harness"], a),
            "steady_call_ms": steady_ms(calls),
            "finite": bool(torch.isfinite(x).all()),
            "rel_to_naive": rel_l2(x, x_refs[name])}
        del fast, x
        release(device)
    return out


def check_autotune_path(res, iters: int = CG_ITERS) -> None:
    for name, r in res.items():
        amort = r["record"]["amortized_s"]
        measured = {n for n, c in r["candidates"].items() if c is not None}
        require(r["timing_calls"] > 0 and set(amort) == measured,
                f"autotune {name}: every surviving candidate measured, got "
                f"{sorted(amort)} of {sorted(r['candidates'])}")
        require(r["winner"] == r["record"]["harness"]
                == min(amort, key=amort.get),
                f"autotune {name}: the winner {r['winner']} has the least "
                f"amortized cost of {amort}")
        if r["kernel"] is not None:
            require(r["launches"][r["kernel"]] == iters + 1,
                    f"autotune {name}: {r['kernel']} launched once per CG "
                    f"SpMV ({iters + 1}), got {r['launches']}")
        require(r["finite"] and r["rel_to_naive"] <= CG_RTOL,
                f"autotune {name}: CG iterate within {CG_RTOL} of the naive "
                f"CG, got {r['rel_to_naive']:.3g}")


def warm_start(seed: int, device, **sizes) -> dict:
    """The second process on the autotune store: one call of each
    matrix's compiled SpMV; what it selected and what it timed."""
    from repro_torch import lilac
    from repro_torch.core.harness import REGISTRY

    out = {}
    for name, (a, b) in matrices(seed, device, **sizes).items():
        fast = lilac.compile(naive_spmv, mode="host", policy="autotune",
                             device=device)
        fast(a.val, a.col_ind, a.row_ptr, b)
        out[name] = fast.last_selections[0][1]
    out["stats"] = REGISTRY.autotuner.stats.as_dict()
    return out


def run_warm_start(seed: int, store: Path, flag: str = "--warm-start",
                   **env_vars) -> dict:
    """A second process of this script on the store (``flag`` picks what
    it runs; ``env_vars`` set its environment)."""
    env = dict(os.environ, LILAC_TORCH_AUTOTUNE_CACHE=str(store),
               **env_vars)
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--seed", str(seed), flag], env=env,
                       capture_output=True, text=True, timeout=600)
    if p.returncode != 0:
        raise RuntimeError(f"warm-start process failed:\n{p.stderr[-4000:]}")
    res = json.loads(p.stdout.strip().splitlines()[-1])
    res["seconds"] = time.perf_counter() - t0
    return res


def check_warm_start(warm, res) -> None:
    stats = warm["stats"]
    require(stats["timing_calls"] == 0 and stats["elimination_calls"] == 0
            and stats["disk_hits"] == 1
            and stats["disk_hits"] + stats["memory_hits"] == len(res),
            f"warm start: zero candidates re-timed, every signature served "
            f"from the store read once, got {stats}")
    for name, r in res.items():
        require(warm[name] == r["winner"],
                f"warm start {name}: the same winner {r['winner']}, got "
                f"{warm[name]}")


# ---------------------------------------------------------------------------
# Executable plans: the CG calls replayed from one CUDA graph
# ---------------------------------------------------------------------------

#: (matrix, policy, kernel module, kernel body) of the plan phase's CGs
PLAN_CASES = (("npb", "cuda.ell", "spmv_ell", "spmv_ell_staged"),
              ("hpcg", "cuda.ell", "spmv_ell", "spmv_ell_windowed"),
              ("hpcg", "cuda.bcsr", "bsr_spmm", "bsr_spmm_narrow"))


def _launch_counter(module: str):
    from repro_torch.kernels.bsr_spmm import kernel as B
    from repro_torch.kernels.spmv_ell import kernel as K

    return {"spmv_ell": K, "bsr_spmm": B}[module]


def plan_path(mats, device, iters: int = CG_ITERS, reps: int = 20):
    """Each of PLAN_CASES' CGs through lilac.compile(naive_spmv,
    mode="host", policy=...) with bake=True (the default: a plan, replayed
    from a CUDA graph after the first call) and bake=False (the
    interpreter on every call): the steady call, one call's device and
    host-enqueue ms, plan_info, repacks and launches; then an in-place
    val.mul_(2) between two calls."""
    import torch
    from repro_torch import lilac

    out = {}
    for name, policy, module, body in PLAN_CASES:
        a, b = mats[name]
        counter = _launch_counter(module)
        xs = {}
        for bake in (True, False):
            fast = lilac.compile(naive_spmv, mode="host", policy=policy,
                                 device=device, bake=bake)
            counter.reset_launches()
            calls: list = []
            xs[bake] = cg(timed(fast, calls, device), a, b, iters)
            sync(device)
            r = {"launches": counter.LAUNCHES[body],
                 "plan_info": fast.plan_info(),
                 "repacks": fast.cache.stats.misses,
                 "steady_call_ms": steady_ms(calls),
                 "selections": [n for _, n in fast.last_selections]}
            p = xs[bake].clone()
            r["call_ms"] = cuda_ms(
                lambda: fast(a.val, a.col_ind, a.row_ptr, p), reps) \
                if device.type == "cuda" else (None, None)
            # an in-place write to the matrix between two calls
            val = a.val.clone()
            fast(val, a.col_ind, a.row_ptr, p)
            before = fast.cache.stats.misses
            val.mul_(2)
            got = fast(val, a.col_ind, a.row_ptr, p)
            want = naive_spmv(val, a.col_ind, a.row_ptr, p)
            r["edit"] = {"repacks": fast.cache.stats.misses - before,
                         "max_abs_err": max_err(got, want)[0],
                         "within_tol": max_err(got, want)[1] <= 1.0,
                         "rebakes": fast.plan_info()["rebakes"]}
            out[f"{name} {policy} bake={bake}"] = r
            del fast, val, got, want, p
            release(device)
        out[f"{name} {policy}"] = {
            "equal": bool(torch.equal(xs[True], xs[False])),
            "rel": rel_l2(xs[True], xs[False]), "body": body,
            "finite": bool(torch.isfinite(xs[True]).all())}
        del xs
    return out


def check_plan_path(res, iters: int = CG_ITERS) -> None:
    calls = iters + 1
    for name, policy, _, body in PLAN_CASES:
        pair = res[f"{name} {policy}"]
        for bake in (True, False):
            r = res[f"{name} {policy} bake={bake}"]
            info = r["plan_info"]
            what = f"plans {name} {policy} bake={bake}"
            if bake:
                require(info["baked"] == 1 and not info["bake_errors"]
                        and info["plan_hits"] == calls - 1
                        and info["plans"][0]["cuda_graph"],
                        f"{what}: baked into a CUDA graph, no bake error, "
                        f"{calls - 1} plan hits, got {info}")
            else:
                require(info["baked"] == 0 and info["plan_hits"] == 0,
                        f"{what}: the interpreter on every call, got {info}")
            require(r["selections"] == [policy] and r["repacks"] == 1,
                    f"{what}: {policy} and one repack, got "
                    f"{r['selections']}, {r['repacks']}")
            require(r["launches"] == calls,
                    f"{what}: {body} launched once per CG SpMV ({calls}), "
                    f"got {r['launches']}")
            e = r["edit"]
            require(e["repacks"] == 1 and e["within_tol"],
                    f"{what}: an in-place val.mul_(2) re-marshals and gives "
                    f"the naive result, got {e}")
        # the same kernels in the same order on the same inputs
        require(pair["finite"] and pair["equal"],
                f"plans {name} {policy}: the plan's CG iterate equals the "
                f"interpreter's bit for bit, got |dx|/|x| {pair['rel']:.3g}")


def two_hops(val, col, row_ptr, v):
    """A @ (A @ v) with the textbook SpMV: two matches on one matrix,
    coupled by the repack they may share."""
    return naive_spmv(val, col, row_ptr, naive_spmv(val, col, row_ptr, v))


def joint_path(a, b, device, calls: int = 3) -> dict:
    """two_hops at one matrix under policy="autotune", on the tuner store
    of the autotune phase: the joint plan search runs once both matches
    are pinned (re-costing the store's records, timing nothing), the
    entry then bakes; its report, selections, plan_info and the output
    against the uncompiled two_hops."""
    from repro_torch import lilac
    from repro_torch.core.harness import REGISTRY
    from repro_torch.kernels.bsr_spmm import kernel as B
    from repro_torch.kernels.spmv_ell import kernel as K

    tuner = REGISTRY.autotuner
    timed_before = tuner.stats.timing_calls
    fast = lilac.compile(two_hops, mode="host", policy="autotune",
                         device=device)
    K.reset_launches()
    B.reset_launches()
    sels = []
    for _ in range(calls):
        y = fast(a.val, a.col_ind, a.row_ptr, b)
        sels.append([n for _, n in fast.last_selections])
    sync(device)
    info = fast.plan_info()
    res = {"matches": len(fast.last_report.matches), "selections": sels,
           "plan_info": {k: v for k, v in info.items() if k != "plans"},
           "plans": info["plans"],
           "timing_calls": tuner.stats.timing_calls - timed_before,
           "launches": {**K.LAUNCHES, **B.LAUNCHES},
           "rel_to_naive": rel_l2(y, two_hops(a.val, a.col_ind, a.row_ptr,
                                              b)),
           "repacks": fast.cache.stats.misses}
    del fast, y
    release(device)
    return res


def check_joint_path(res, calls: int = 3) -> None:
    info = res["plan_info"]
    require(res["matches"] == 2, f"joint: two SpMV matches, got "
            f"{res['matches']}")
    require(info["joint_searched"] == 1 and len(info["joint"]) == 1,
            f"joint: the search ran once, got {info}")
    j = info["joint"][0]
    require(len(j["assignment"]) == 2
            and j["cost_s"] <= j["greedy_cost_s"]
            and j["cost_s"] <= j["independent_cost_s"],
            f"joint: an assignment for both matches costing no more than "
            f"greedy's or the independent winners', got {j}")
    require(res["selections"][-1] == [h for h, _, _ in j["assignment"]],
            f"joint: the last call ran the joint assignment, got "
            f"{res['selections'][-1]} for {j['assignment']}")
    require(info["baked"] == 1 and not info["bake_errors"]
            and info["plan_hits"] >= 1,
            f"joint: the entry baked and its plan served a call, got {info}")
    require(res["rel_to_naive"] <= KERNEL_RTOL,
            f"joint: |y - y_naive| / |y_naive| within {KERNEL_RTOL}, got "
            f"{res['rel_to_naive']:.3g}")


def plan_warm_start(seed: int, device, **sizes) -> dict:
    """The second process on plans.json, with an empty tuner store: each
    plan entry of the first process compiled again and called once; the
    detection calls it made, what it timed, what it selected."""
    from repro_torch import lilac
    from repro_torch.core import detect as D
    from repro_torch.core.harness import REGISTRY

    calls = {"n": 0}
    orig = D.Detector.detect

    def spy(det, gm):
        calls["n"] += 1
        return orig(det, gm)

    D.Detector.detect = spy
    mats = matrices(seed, device, **sizes)
    out = {"selections": {}, "baked": {}}
    for name, policy in [("npb", "autotune"), ("hpcg", "autotune")] + [
            (n, p) for n, p, _, _ in PLAN_CASES]:
        a, b = mats[name]
        fast = lilac.compile(naive_spmv, mode="host", policy=policy,
                             device=device)
        fast(a.val, a.col_ind, a.row_ptr, b)
        key = f"{name} {policy}"
        out["selections"][key] = fast.last_selections[0][1]
        out["baked"][key] = fast.plan_info()["baked"]
        del fast
    out["detect_calls"] = calls["n"]
    out["tuner"] = REGISTRY.autotuner.stats.as_dict()
    return out


def check_plan_warm_start(warm, tuned) -> None:
    require(warm["detect_calls"] == 0,
            f"plan warm start: zero detection calls, got "
            f"{warm['detect_calls']}")
    t = warm["tuner"]
    require(t["timing_calls"] == 0 and t["elimination_calls"] == 0,
            f"plan warm start: zero candidates re-timed, got {t}")
    want = {f"{n} autotune": r["winner"] for n, r in tuned.items()}
    want.update({f"{n} {p}": p for n, p, _, _ in PLAN_CASES})
    require(warm["selections"] == want,
            f"plan warm start: the same selections {want}, got "
            f"{warm['selections']}")
    require(all(v == 1 for v in warm["baked"].values()),
            f"plan warm start: every entry baked, got {warm['baked']}")


def graph_replay(fn, reps: int):
    """``fn()`` eagerly and as a captured CUDA graph: (eager outputs,
    replayed outputs, device ms and host ms a call of each)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = fn()
    eager = fn()
    graph.replay()
    torch.cuda.synchronize()
    return (eager, replayed, cuda_ms(fn, reps), cuda_ms(graph.replay, reps))


def trace_numbers(fn, args, name: str, op: str, device, reps: int):
    """``fn`` compiled in trace mode against host mode, and its rewritten
    graph eagerly and replayed in a CUDA graph."""
    import torch
    from repro_torch import lilac

    fast = lilac.compile(fn, device=device)
    host = lilac.compile(fn, mode="host", device=device)
    got = fast(*args)
    want = host(*args)
    gm = fast.graph_for(*args)
    res = {"selections": [n for _, n in fast.last_selections],
           "op_nodes": sum(n.target == getattr(torch.ops.lilac_torch,
                                               op).default
                           for n in gm.graph.nodes),
           "nodes": len(gm.graph.nodes),
           "equal_to_host": bool(torch.equal(got, want)), "want": name}
    if device.type == "cuda":
        eager, replayed, g_ms, r_ms = graph_replay(lambda: gm(*args), reps)
        res.update(
            replay_equal=bool(torch.equal(eager[0], replayed[0])),
            trace_call_ms=cuda_ms(lambda: fast(*args), reps),
            host_call_ms=cuda_ms(lambda: host(*args), reps),
            graph_ms=g_ms, replay_ms=r_ms)
    return res


def check_trace(res, what: str) -> None:
    require(res["selections"] == [res["want"]] and res["op_nodes"] == 1,
            f"trace {what}: {res['want']} as one custom-op node, got "
            f"{res['selections']} and {res['op_nodes']} op nodes")
    require(res["equal_to_host"], f"trace {what}: equal to host mode")
    require(res.get("replay_equal", True),
            f"trace {what}: the CUDA-graph replay equals the eager call")


def slab_variants(a, seed: int, device, reps: int = 20):
    """K1's direct body at every rows_per_slab of SLAB_PROBE, on NPB-C's
    lane-128 ELL as the ELL layer calls it and on its first SMALL_ROWS
    rows, against the plain version and bit for bit against the default
    slab (the values cuda.ell declares are marked); and the ELL layer in
    trace mode."""
    import torch
    from repro_torch import lilac
    from repro_torch.kernels.spmv_ell import kernel as K
    from repro_torch.kernels.spmv_ell import ref as R
    from repro_torch.sparse import ell_from_csr

    ell = ell_from_csr(a, lane=128)
    rng = torch.Generator(device="cpu").manual_seed(seed)
    vec = torch.randn(a.cols, generator=rng).to(device)
    bias = torch.randn(a.rows, generator=rng).to(device)
    on_card = device.type == "cuda"
    declared = [s["rows_per_slab"] for s in
                lilac.REGISTRY.get("spmv_ell", "cuda.ell").schedules]
    variants = {}
    for rows in (a.rows, min(a.rows, SMALL_ROWS)):
        val, col, b = ell.val[:rows], ell.col[:rows], bias[:rows]
        kw = dict(bias=b, epilogue="relu")
        nnz = int(torch.diff(a.row_ptr.long())[ell.perm[:rows].long()].sum())
        base = K.spmv_ell_cuda(val, col, vec, rows_per_slab=declared[0],
                               **kw)
        io = nbytes(vec, b) + rows * 4
        for rs in SLAB_PROBE:
            run = lambda: K.spmv_ell_cuda(val, col, vec, rows_per_slab=rs,
                                          **kw)
            v = variants[f"{rs} at {rows} rows"] = variant_numbers(
                run, lambda: R.spmv_ell_plain(val, col, vec, **kw),
                "spmv_ell_kernel", on_card, reps, nnz * 8 + io, 2 * nnz,
                a.val.dtype, what=f"spmv_ell rows_per_slab={rs} at {rows}")
            v["declared"] = rs in declared
            v["equal_to_default"] = bool(torch.equal(run(), base))
    trace = trace_numbers(ell_layer, (ell.val, ell.col, vec, bias),
                          "cuda.ell", "spmv_ell", device, reps)
    return {"variants": variants, "trace": trace}


def check_variants(variants, what: str) -> None:
    for k, v in variants.items():
        require(v["equal_to_default"],
                f"{what}={k} computes the default variant's bits")


def moe_trace_path(cfg, p, x, device, reps: int = 10):
    """The OLMoE expert FFN of one sequence in trace mode (K4 as the
    custom op) against host mode and replayed in a CUDA graph; the same
    under policy="autotune" in trace mode (cuda.gmm's tm swept beside the
    other candidates); and K4 at every tm cuda.gmm declares against its
    plain version, moe_ffn bit for bit across them."""
    import torch
    from repro_torch import lilac
    from repro_torch.core.harness import REGISTRY
    from repro_torch.kernels.moe_gmm import kernel as G
    from repro_torch.kernels.moe_gmm import ops as GO
    from repro_torch.kernels.moe_gmm import ref as GR
    from repro_torch.models import layers as L

    gate, idx, _ = L.moe_router(p, x[:1], cfg.moe_topk)
    args = (x[0], gate[0], idx[0], p["wg"], p["wu"], p["wd"])
    res = {"trace": trace_numbers(L._moe_naive_2d, args, "cuda.gmm",
                                  "moe_ffn", device, reps)}
    tuned = lilac.compile(L._moe_naive_2d, policy="autotune", device=device)
    out = tuned(*args)
    tuner = REGISTRY.autotuner
    rec = tuner.cache.entries[tuner.last_decision.sig]["trace"]
    winner = tuned.last_selections[0][1]
    # the winner's own function, pinned by name at its default schedule
    # (every tm computes the same bits)
    pinned = lilac.compile(L._moe_naive_2d, policy=winner, device=device)
    res["autotune"] = {"winner": winner,
                       "schedule": tuned.last_schedules[0],
                       "variant_s": rec["variant_s"],
                       "amortized_s": rec["amortized_s"],
                       "equal_to_pinned": bool(torch.equal(out,
                                                           pinned(*args))),
                       "finite": bool(torch.isfinite(out).all()),
                       "rel_l2": rel_l2(out, GR.moe_ffn_ref(*args))}
    on_card = device.type == "cuda"
    T, K = idx.shape[1:]
    E, D, F = p["wg"].shape
    tiles = [s["tm"] for s in REGISTRY.get("moe_ffn", "cuda.gmm").schedules]
    base = GO.moe_ffn(*args, tm=tiles[0])
    variants = {}
    for tm in tiles:
        dest, te, tp = GO._route(idx[0], T, K, E, tm)
        xs = torch.zeros((tp, D), dtype=x.dtype, device=device)
        xs[dest] = x[0].repeat_interleave(K, dim=0)
        nb = T * K * D * xs.element_size() + nbytes(p["wg"]) + T * K * F * 4
        v = variants[tm] = variant_numbers(
            lambda: G.gmm_cuda(xs, p["wg"], te, tm),
            lambda: GR.gmm_ref(xs, p["wg"], te, tm), "gmm_tc_kernel",
            on_card, reps, nb, 2 * T * K * D * F, x.dtype, GMM_ATOL,
            GMM_RTOL, what=f"gmm tm={tm}")
        v["tp"] = tp
        v["equal_to_default"] = bool(torch.equal(
            GO.moe_ffn(*args, tm=tm), base))
        del xs
    res["variants"] = variants
    return res


def check_moe_trace(res) -> None:
    check_trace(res["trace"], "MoE")
    a = res["autotune"]
    require(sorted(a["variant_s"].get("cuda.gmm", {})) == sorted(
        f"tm={v}" for v in res["variants"]),
            f"trace autotune: every tm of cuda.gmm swept, got "
            f"{a['variant_s']}")
    require(a["winner"] == min(a["amortized_s"], key=a["amortized_s"].get),
            f"trace autotune: the winner has the least cost, got "
            f"{a['winner']} of {a['amortized_s']}")
    require(a["finite"] and a["equal_to_pinned"],
            f"trace autotune: a finite output equal to the winner "
            f"{a['winner']}'s when it is named, got {a}")
    require(a["rel_l2"] <= MOE_RTOL,
            f"trace autotune: relative L2 error vs the f32 oracle within "
            f"{MOE_RTOL}, got {a['rel_l2']:.3g} ({a['winner']})")
    check_variants(res["variants"], "moe_ffn tm")


# ---------------------------------------------------------------------------
# Containment: faults injected on the card, quarantine, shadow checks
# ---------------------------------------------------------------------------

SHADOW_PLAN_CALLS = CG_ITERS            # the NPB-C CG's plan calls
CONTAIN_GNN_STEPS = 3


@contextlib.contextmanager
def fault_free(what: str):
    """A phase that injects no fault: it must show no containment event
    and no quarantine skip (each one warns) and leave the quarantine store
    empty."""
    from repro_torch.core.resilience import (LilacContainmentWarning,
                                             QuarantineStore)

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always", LilacContainmentWarning)
        yield
    events = [str(w.message) for w in seen
              if issubclass(w.category, LilacContainmentWarning)]
    for w in seen:
        if not issubclass(w.category, LilacContainmentWarning):
            print(f"warning in {what}: {w.category.__name__}: {w.message}",
                  file=sys.stderr)
    skips = [e for e in events if "is quarantined and skipped" in e]
    require(not events, f"{what}: no containment event and no quarantine "
            f"skip, got {len(skips)} skips in {events}")
    active = QuarantineStore(os.environ["LILAC_TORCH_QUARANTINE_CACHE"])
    require(not active.active(), f"{what}: an empty quarantine store, got "
            f"{active.active()}")


def _contained(fn):
    """(result, containment warnings) of ``fn()``."""
    from repro_torch.core.resilience import LilacContainmentWarning

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always", LilacContainmentWarning)
        out = fn()
    return out, [str(w.message) for w in seen
                 if issubclass(w.category, LilacContainmentWarning)]


def kernel_raise_path(a, b, x_ref, device, iters: int = CG_ITERS):
    """``kernel_raise:cuda.ell`` on the NPB-C CG (policy="cuda.ell", baked):
    the first call quarantines cuda.ell and falls back; a new function
    skips it with no containment event but with a skip warning and count;
    with the store cleared cuda.ell (K1 staged) runs again."""
    from repro_torch import lilac
    from repro_torch.core import faults
    from repro_torch.core.resilience import QuarantineStore, shared_quarantine
    from repro_torch.kernels.spmv_ell import kernel as K

    def compiled():
        return lilac.compile(naive_spmv, mode="host", policy="cuda.ell",
                             device=device)

    fast = compiled()
    with faults.inject("kernel_raise:cuda.ell") as plan:
        x, events = _contained(lambda: cg(fast, a, b, iters))
    sync(device)
    on_disk = QuarantineStore(
        os.environ["LILAC_TORCH_QUARANTINE_CACHE"]).active()
    res = {"fired": len(plan.fired), "events": events,
           "fallback": [n for _, n in fast.last_selections],
           "containment": fast.resilience_info()["containment"],
           "plan_hits": fast.plan_info()["plan_hits"],
           "quarantined": sorted(on_disk),
           "rel_to_naive": rel_l2(x, x_ref)}
    del fast
    again = compiled()
    K.reset_launches()
    (x2, events2) = _contained(lambda: cg(again, a, b, 2))
    res.update(skip_selections=[n for _, n in again.last_selections],
               skip_events=events2,
               skip_containment=again.resilience_info()["containment"],
               skip_launches=K.LAUNCHES["spmv_ell_staged"])
    del again
    shared_quarantine().clear()
    third = compiled()
    K.reset_launches()
    x3 = cg(third, a, b, iters)
    sync(device)
    res.update(cleared_selections=[n for _, n in third.last_selections],
               cleared_launches=K.LAUNCHES["spmv_ell_staged"],
               cleared_rel_to_naive=rel_l2(x3, x_ref))
    del third
    release(device)
    return res


def check_kernel_raise_path(res, iters: int = CG_ITERS) -> None:
    require(res["rel_to_naive"] <= CG_RTOL,
            f"kernel_raise: the 25 iterates within {CG_RTOL} of x_naive, got "
            f"{res['rel_to_naive']:.3g}")
    require(res["quarantined"] == ["spmv_csr|cuda.ell|default"],
            f"kernel_raise: exactly (spmv_csr, cuda.ell, default) on disk, "
            f"got {res['quarantined']}")
    require(res["fallback"] and res["fallback"] != ["cuda.ell"]
            and len(res["events"]) == 1 and res["fired"] == 1,
            f"kernel_raise: one contained event and a named fallback, got "
            f"{res['events']}, {res['fallback']}")
    skip = res["skip_containment"]
    require(res["skip_selections"] == res["fallback"]
            and skip["quarantines"] == 0 and skip["contained_exceptions"] == 0
            and skip["quarantine_skips"] >= 1
            and len(res["skip_events"]) == skip["quarantine_skips"]
            and all("'cuda.ell'" in e and "is quarantined and skipped" in e
                    for e in res["skip_events"])
            and res["skip_launches"] == 0,
            f"kernel_raise: a new function skips cuda.ell with no containment "
            f"event and one warned, counted skip, got "
            f"{res['skip_selections']}, {skip}, {res['skip_events']}")
    require(res["cleared_selections"] == ["cuda.ell"]
            and res["cleared_launches"] == iters + 1
            and res["cleared_rel_to_naive"] <= CG_RTOL,
            f"kernel_raise: with the store cleared cuda.ell runs K1 staged "
            f"{iters + 1} times, got {res['cleared_selections']}, "
            f"{res['cleared_launches']}")


def nan_output_path(a, seed: int, device, steps: int = CONTAIN_GNN_STEPS,
                    width: int = GNN_WIDTH):
    """``nan_output:cuda.bcsr`` on ``steps`` GNN steps: the NaN output of
    K3 is caught by the validator, the step falls back, the output is the
    uncompiled loop's."""
    import torch
    from repro_torch import lilac
    from repro_torch.core import faults
    from repro_torch.core.resilience import shared_quarantine

    gen = torch.Generator(device=device).manual_seed(seed + 2)
    h0 = torch.randn((a.cols, width), generator=gen, device=device)
    bias = torch.randn(width, generator=gen, device=device)
    fast = lilac.compile(gnn_step, mode="host", device=device)

    def loop(step):
        h = h0
        for _ in range(steps):
            h = step(a.val, a.col_ind, a.row_ptr, h, bias)
            h = h / h.abs().max()
        return h

    with faults.inject("nan_output:cuda.bcsr") as plan:
        h, events = _contained(lambda: loop(fast))
    res = {"fired": len(plan.fired), "events": events,
           "selections": [n for _, n in fast.last_selections],
           "containment": fast.resilience_info()["containment"],
           "finite": bool(torch.isfinite(h).all())}
    del fast
    release(device)
    res["rel_to_naive"] = rel_l2(h, loop(gnn_step))
    shared_quarantine().clear()
    release(device)
    return res


def check_nan_output_path(res) -> None:
    c = res["containment"]
    require(c["nonfinite_outputs"] >= 1 and c["quarantines"] >= 1
            and res["events"] and res["selections"] != ["cuda.bcsr"],
            f"nan_output: the NaN output of cuda.bcsr contained, got {c}, "
            f"{res['selections']}")
    require(res["finite"] and res["rel_to_naive"] <= GNN_RTOL,
            f"nan_output: the GNN output within {GNN_RTOL} of the naive "
            f"loop, got {res['rel_to_naive']:.3g}")


def shadow_path(mats, x_ref, cfg, p, x, device, iters: int = CG_ITERS):
    """Shadow checks at rate 1: the NPB-C CG's plan calls (cuda.ell) and
    two MoE blocks (cuda.gmm, bf16) against the uncompiled program, then
    ``shadow_diverge:dispatch`` on the BCSR CG at HPCG."""
    import torch
    from repro_torch import lilac
    from repro_torch.core import faults
    from repro_torch.core.resilience import shared_quarantine
    from repro_torch.kernels.bsr_spmm import kernel as B
    from repro_torch.models import layers as L

    os.environ["LILAC_TORCH_SHADOW_RATE"] = "1"
    try:
        a, b = mats["npb"]
        fast = lilac.compile(naive_spmv, mode="host", policy="cuda.ell",
                             device=device)
        calls: list = []
        xs, events = _contained(lambda: cg(timed(fast, calls, device), a, b,
                                           iters))
        res = {"npb": {"info": fast.resilience_info(), "events": events,
                       "plan_hits": fast.plan_info()["plan_hits"],
                       "steady_call_ms": steady_ms(calls),
                       "rel_to_naive": rel_l2(xs, x_ref)}}
        del fast
        moe = L._lilac_moe_2d(device.type)
        before = dict(moe.resilience_stats.as_dict())
        calls = []
        for _ in range(2):
            timed(lambda: L.moe_block(p, x, topk=cfg.moe_topk,
                                      impl="lilac"), calls, device)()
        after = moe.resilience_stats.as_dict()
        res["moe"] = {k: after[k] - before[k] for k in after}
        res["moe"]["block_ms"] = [1e3 * t for t in calls]
        # a forced divergence on the BCSR CG's plan
        a, b = mats["hpcg"]
        fast = lilac.compile(naive_spmv, mode="host", policy="cuda.bcsr",
                             device=device)
        fast(a.val, a.col_ind, a.row_ptr, b)        # bakes
        with faults.inject("shadow_diverge:dispatch") as plan:
            got = fast(a.val, a.col_ind, a.row_ptr, b)
        want = naive_spmv(a.val, a.col_ind, a.row_ptr, b)
        r = {"fired": len(plan.fired), "served_naive": bool(
            torch.equal(got, want)), "baked_after": fast.plan_info()["baked"],
             "quarantined": sorted(shared_quarantine().active()),
             "divergences": fast.resilience_info()["containment"][
                 "shadow_divergences"]}
        B.reset_launches()
        nxt = fast(a.val, a.col_ind, a.row_ptr, b)
        sync(device)
        r.update(next_selections=[n for _, n in fast.last_selections],
                 next_launches=B.LAUNCHES["bsr_spmm_narrow"],
                 next_max_err=max_err(nxt, want)[1])
        res["bcsr"] = r
        del fast
    finally:
        os.environ.pop("LILAC_TORCH_SHADOW_RATE", None)
    shared_quarantine().clear()
    release(device)
    return res


def check_shadow_path(res, iters: int = CG_ITERS, batch: int = MOE_BATCH
                      ) -> None:
    n = res["npb"]
    c = n["info"]["containment"]
    require(c["shadow_checks"] == iters and c["shadow_divergences"] == 0
            and n["plan_hits"] == iters and not n["events"]
            and n["rel_to_naive"] <= CG_RTOL,
            f"shadow: {iters} NPB-C plan calls checked with no divergence, "
            f"got {c}, {n['plan_hits']} plan hits")
    m = res["moe"]
    require(m["shadow_checks"] == 2 * batch and m["shadow_divergences"] == 0,
            f"shadow: {2 * batch} MoE calls checked with no divergence (bf16 "
            f"tolerance), got {m}")
    r = res["bcsr"]
    require(r["fired"] == 1 and r["served_naive"] and r["baked_after"] == 0
            and r["divergences"] == 1
            and r["quarantined"] == ["spmv_csr|cuda.bcsr|default"],
            f"shadow_diverge: the naive answer served, the plan torn down, "
            f"cuda.bcsr quarantined, got {r}")
    require(r["next_selections"] not in ([], ["cuda.bcsr"])
            and r["next_launches"] == 0 and r["next_max_err"] <= 1.0,
            f"shadow_diverge: the next call runs without cuda.bcsr, got "
            f"{r['next_selections']}, {r['next_launches']} K3 launches")


def chaos_path(mats, seed: int, device, work: str) -> dict:
    """The combined fault spec of tools/chaos_smoke_torch.py under
    policy="autotune" at NPB-C and HPCG, every store in a directory of its
    own (the tuner measures afresh)."""
    import importlib.util

    import torch

    spec = importlib.util.spec_from_file_location(
        "chaos_smoke_torch", ROOT / "tools" / "chaos_smoke_torch.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tool.redirect_stores(str(Path(work) / "chaos"))
    gen = torch.Generator(device=device).manual_seed(seed + 5)
    problems = {name: (a, torch.randn(a.cols, generator=gen, device=device))
                for name, (a, _) in mats.items()}
    t0 = time.perf_counter()
    sweep = tool.oracle_sweep(problems, seed, device.type)
    res = {"sweep": sweep, "seconds": time.perf_counter() - t0,
           "spec": tool.CHAOS_SPEC,
           "repro": f"python3 chip_smoke.py --seed {seed}"}
    res.update(tool.gates(sweep))
    release(device)
    return res


def check_chaos_path(res) -> None:
    for gate in ("zero_uncontained_exceptions", "results_match_oracle",
                 "quarantines_persisted"):
        require(res[gate], f"chaos: {gate}, got {res['sweep']}; replay with "
                f"{res['repro']}")
    require(res["sweep"]["faults_fired"] > 0, "chaos: faults fired")



def print_trace(res, what: str) -> None:
    t = res
    line = (f"trace {what}: {t['selections']} as {t['op_nodes']} custom-op "
            f"node of {t['nodes']}; equal to host mode: "
            f"{t['equal_to_host']}")
    if "replay_ms" in t:
        line += (f"; CUDA-graph replay equal: {t['replay_equal']}; a call "
                 f"(device ms, host ms to enqueue): host mode "
                 f"{t['host_call_ms'][0]:.4f}/{t['host_call_ms'][1]:.4f}, "
                 f"trace mode {t['trace_call_ms'][0]:.4f}/"
                 f"{t['trace_call_ms'][1]:.4f}, its graph module "
                 f"{t['graph_ms'][0]:.4f}/{t['graph_ms'][1]:.4f}, replay "
                 f"{t['replay_ms'][0]:.4f}/{t['replay_ms'][1]:.4f}")
    print(line)


def _ms(t) -> str:
    return "not measured" if t is None else f"{t:.4f}"


def print_tune_variants(variants, what: str, tol: str) -> None:
    for k, v in variants.items():
        print(f"{what}={k}: max|err| {v['max_abs_err']:.3g} ({tol}), "
              f"{_ms(v['ms'])} ms (host {_ms(v['host_ms'])} ms; profiler "
              f"{_ms(v['profiler_ms'])} ms a launch), plain "
              f"{_ms(v['plain_ms'])} ms, bound {v['bound_ms']:.4f} ms "
              f"({v['bound_by']}); bits equal to the default: "
              f"{v['equal_to_default']}"
              + (f"; Tp {v['tp']}" if "tp" in v else "")
              + ("" if v.get("declared", True) else " (not declared)"))


# ---------------------------------------------------------------------------

def sass_functions(library: Path) -> dict:
    """Each kernel function of the library (its mangled name) -> how many
    SASS instructions of each opcode it holds, modifiers included (e.g.
    ``LDS.128``), from the ``Function :`` sections of ``cuobjdump -sass``."""
    import collections
    import re

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(library)], check=True,
                          capture_output=True, text=True).stdout
    funcs: dict = {}
    current = None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current = funcs.setdefault(m.group(1), collections.Counter())
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     line)
        if m and current is not None:
            current[m.group(1)] += 1
    return funcs


def sass_summary(counts) -> dict:
    """One function's SASS opcodes by base name (``FFMA``, ``HGMMA``, ...),
    except that shared and global loads and shared stores are split by
    width: ``LDS`` / ``LDG`` / ``STS`` count the 32-bit forms,
    ``LDS.128`` / ``LDG.128`` / ``STS.128`` the 128-bit ones (64-bit and
    narrower forms are left out)."""
    out: dict = {}
    for op, n in counts.items():
        base, *mods = op.split(".")
        key = base
        if base in ("LDS", "LDG", "STS"):
            if "128" in mods:
                key = base + ".128"
            elif any(m in ("64", "U16", "S16", "U8", "S8") for m in mods):
                continue
        out[key] = out.get(key, 0) + n
    return out


def check_k4_sass(library: Path) -> dict:
    """K4's two bodies from their own SASS: the bf16 body issues HGMMA (the
    tensor cores), the f32 body FFMA and no HMMA or HGMMA (full f32 on the
    CUDA cores).  Returns each function's summary."""
    funcs = {name: sass_summary(c) for name, c in
             sass_functions(library).items()
             if "gmm_tc_kernel" in name or "gmm_simt_kernel" in name}
    tc = [c for n, c in funcs.items() if "gmm_tc_kernel" in n]
    simt = [c for n, c in funcs.items() if "gmm_simt_kernel" in n]
    require(len(tc) == 1 and tc[0].get("HGMMA", 0) > 0,
            f"K4's bf16 body runs on the tensor cores (HGMMA), got {tc}")
    require(len(simt) >= 1 and all(
        c.get("FFMA", 0) > 0 and not c.get("HMMA") and not c.get("HGMMA")
        for c in simt),
            f"K4's f32 body is FFMA with no HMMA or HGMMA, got {simt}")
    return funcs


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
    "gmm_f32": "src/repro/kernels/moe_gmm/kernel.py:53",
}
SOURCES = {
    "spmv_ell_staged": "src/repro_torch/kernels/spmv_ell/csrc/spmv_ell.cu",
    "spmv_ell": "src/repro_torch/kernels/spmv_ell/csrc/spmv_ell.cu",
    "spmv_ell_windowed": "src/repro_torch/kernels/spmv_ell/csrc/spmv_ell.cu",
    "bsr_spmm_wide": "src/repro_torch/kernels/bsr_spmm/csrc/bsr_spmm.cu",
    "bsr_spmm_narrow": "src/repro_torch/kernels/bsr_spmm/csrc/bsr_spmm.cu",
    "gmm": "src/repro_torch/kernels/moe_gmm/csrc/moe_gmm.cu",
    "gmm_f32": "src/repro_torch/kernels/moe_gmm/csrc/moe_gmm.cu",
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
    ap.add_argument("--warm-start", action="store_true",
                    help=argparse.SUPPRESS)   # the autotune phase's 2nd run
    ap.add_argument("--plan-warm-start", action="store_true",
                    help=argparse.SUPPRESS)   # the plan phase's 2nd run
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
    if args.warm_start:
        print(json.dumps(warm_start(args.seed, torch.device("cuda"))))
        return 0
    if args.plan_warm_start:
        print(json.dumps(plan_warm_start(args.seed, torch.device("cuda"))))
        return 0
    # the persistent stores (plans, tuner, quarantine) in a directory of
    # this run; no ambient fault plan or shadow rate
    work = tempfile.mkdtemp(prefix="lilac-torch-")
    os.environ["LILAC_TORCH_PLAN_CACHE"] = str(Path(work) / "plans.json")
    os.environ["LILAC_TORCH_QUARANTINE_CACHE"] = str(
        Path(work) / "quarantine.json")
    for k in ("LILAC_TORCH_PLAN_CACHE_DISABLE", "LILAC_TORCH_FAULTS",
              "LILAC_TORCH_FAULTS_SEED", "LILAC_TORCH_SHADOW_RATE"):
        os.environ.pop(k, None)
    try:
        return run(args, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run(args, work: str) -> int:
    import torch

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
    k4_sass = check_k4_sass(build.library_path(G.SOURCE))
    for name, c in k4_sass.items():
        print(f"{G.SOURCE.name} {name}: SASS HGMMA {c.get('HGMMA', 0)}, "
              f"HMMA {c.get('HMMA', 0)}, FFMA {c.get('FFMA', 0)}, 128-bit "
              f"LDS {c.get('LDS.128', 0)}, 32-bit LDS {c.get('LDS', 0)}")

    record = {"card": smi, "k4_sass": k4_sass}
    t0 = time.perf_counter()
    mats = matrices(args.seed, device)
    for name, (a, _) in mats.items():
        print(f"matrix {name}: {a.rows} rows, {a.nnz} stored entries")
    print(f"generated in {time.perf_counter() - t0:.1f}s")

    # -- SpMV on ELL (K1, K2) ------------------------------------------------
    with fault_free("SpMV path"):
        res = main_path(mats, args.seed, device)
    x_refs = res.pop("x_ref")
    x_ref = x_refs["hpcg"]
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
    release(device)

    # -- K1's rows_per_slab variants, the ELL layer in trace mode ------------
    with fault_free("slab variants and the ELL layer in trace mode"):
        slabs = slab_variants(mats["npb"][0], args.seed, device)
    print_tune_variants(slabs["variants"], "spmv_ell rows_per_slab",
                        f"tol atol={KERNEL_ATOL} + rtol={KERNEL_RTOL}*|ref|")
    print_trace(slabs["trace"], "ELL layer (npb)")
    check_variants(slabs["variants"], "spmv_ell rows_per_slab")
    check_trace(slabs["trace"], "ELL layer")
    record["slab_variants"] = slabs
    release(device)

    # -- host-mode autotune at NPB-C and HPCG, then a warm start ------------
    store = Path(work) / "autotune.json"
    os.environ["LILAC_TORCH_AUTOTUNE_CACHE"] = str(store)
    with fault_free("autotune"):
        tuned = autotune_path(mats, x_refs, device)
    for name, r in tuned.items():
        for cand, c in r["candidates"].items():
            print(f"autotune {name} {cand}: " + (
                "raised, eliminated" if c is None else
                f"steady {c['steady_s'] * 1e3:.4f} ms, repack "
                f"{c['marshal_s']:.4f} s, amortized (reuse "
                f"{r['record']['reuse']:g}) {c['amortized_s'] * 1e3:.4f} ms"))
        print(f"autotune {name}: winner {r['winner']} after "
              f"{r['tune_seconds']:.2f}s of tuning ({r['timing_calls']} "
              f"timings); CG {CG_ITERS} it through it, "
              f"{r['steady_call_ms']:.3f} ms a call, |x-x_naive|/|x_naive| = "
              f"{r['rel_to_naive']:.3g}; launches {r['launches']}")
    check_autotune_path(tuned)
    # the tuner's store alone: the plan cache would serve the pins first
    with fault_free("autotune warm start"):
        warm = run_warm_start(args.seed, store,
                              LILAC_TORCH_PLAN_CACHE_DISABLE="1")
    print(f"autotune warm start (a second process, {warm['seconds']:.1f}s): "
          f"{ {k: v for k, v in warm.items() if k in tuned} }, tuner "
          f"{warm['stats']}")
    check_warm_start(warm, tuned)
    record.update(autotune_path=tuned, warm_start=warm)
    release(device)

    # -- executable plans: the CGs replayed from one CUDA graph -------------
    with fault_free("plans"):
        plans = plan_path(mats, device)
    for key, r in plans.items():
        if "bake=" not in key:
            print(f"plans {key}: iterate equal to bake=False's bit for bit: "
                  f"{r['equal']} (|dx|/|x| {r['rel']:.3g}), {r['body']}")
            continue
        info = {k: v for k, v in r["plan_info"].items()
                if k not in ("plans", "joint")}
        print(f"plans {key}: CG {r['steady_call_ms']:.4f} ms a call "
              f"(timed); one call {_ms(r['call_ms'][0])} ms device, "
              f"{_ms(r['call_ms'][1])} ms host enqueue; {r['repacks']} repack; "
              f"launches {r['launches']}; plan_info {info}; plans "
              f"{r['plan_info']['plans']}; in-place val.mul_(2): {r['edit']}")
    check_plan_path(plans)
    with fault_free("plan warm start"):
        pwarm = run_warm_start(args.seed,
                               Path(work) / "autotune-empty.json",
                               "--plan-warm-start")
    print(f"plan warm start (a second process on plans.json, an empty tuner "
          f"store, {pwarm['seconds']:.1f}s): {pwarm['detect_calls']} "
          f"detection calls, tuner {pwarm['tuner']}, selections "
          f"{pwarm['selections']}, baked {pwarm['baked']}")
    check_plan_warm_start(pwarm, tuned)
    record.update(plan_path=plans, plan_warm_start=pwarm)
    with fault_free("joint search"):
        joint = joint_path(*mats["hpcg"], device)
    print(f"joint search hpcg A @ (A @ b) under autotune: selections by "
          f"call {joint['selections']}, report {joint['plan_info']['joint']}"
          f", {joint['timing_calls']} timings, {joint['repacks']} repacks, "
          f"launches {joint['launches']}, |y-y_naive|/|y_naive| = "
          f"{joint['rel_to_naive']:.3g}; plan_info "
          f"{ {k: v for k, v in joint['plan_info'].items() if k != 'joint'} }"
          f"; plans {joint['plans']}")
    check_joint_path(joint)
    record["joint_path"] = joint
    # the containment phase reuses both matrices (0.6 GB); each path drops
    # its compiled functions, whose layouts the data plane holds
    a_hpcg, b_hpcg = mats["hpcg"]
    release(device)

    # -- SpMM and SpMV on BCSR (K3) -----------------------------------------
    with fault_free("SpMM path"):
        spmm = spmm_path(a_hpcg, args.seed, device)
    print(f"SpMM path hpcg x {GNN_WIDTH}: match {spmm['match']} via "
          f"{spmm['selections']}, traced in {spmm['trace_seconds']:.2f}s, "
          f"detected in {spmm['detect_seconds']:.2f}s, {spmm['repacks']} "
          f"repack {spmm['repack_path']} ({spmm['repack_seconds']:.2f}s), "
          f"{spmm['hits']} hits, {spmm['plan_hits']} plan hits; "
          f"{GNN_STEPS} steps in {spmm['seconds']:.2f}s "
          f"(first call {spmm['first_call_s']:.2f}s, then "
          f"{spmm['steady_call_ms']:.3f} ms a call); naive loop "
          f"{spmm['naive_seconds']:.2f}s; |H-H_naive|/|H_naive| = "
          f"{spmm['rel_to_naive']:.3g} (tol {GNN_RTOL}); peak "
          f"{spmm['peak_bytes'] / 2**30:.2f} GiB (naive "
          f"{spmm['naive_peak_bytes'] / 2**30:.2f} GiB), kept "
          f"{spmm['kept_bytes'] / 2**30:.2f} GiB; marshaled "
          f"{spmm['packed']} packed layout of {spmm['tiles']} tiles, "
          f"{spmm['layout_bytes']} B ({spmm['dense_tiles']} dense); K3 "
          f"launches {spmm['launches']}; plan {spmm['plan']}")
    check_spmm_path(spmm)
    release(device)
    with fault_free("BCSR CG"):
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
    del a_hpcg, b_hpcg
    release(device)

    # -- MoE (K4) ------------------------------------------------------------
    p, x = moe_inputs(OLMOE, args.seed, device)
    with fault_free("MoE path"):
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
    gmm, gmm32 = gmm_kernel_phases(OLMOE, p, x, device)
    print(f"gmm Tp {gmm['tp']} rows for {gmm['routed_rows']} routed")
    print_variants(gmm, f"tol atol={GMM_ATOL} + rtol={GMM_RTOL}*|ref|")
    print_variants(gmm32, f"tol atol={GMM_ATOL} + rtol={GMM_RTOL}*|ref|")
    print(f"gmm library (torch._grouped_mm, the gate/up product with a "
          f"bf16 output): {gmm['library_ms']} ms, max|err| vs plain "
          f"{gmm['library_err']}; GEMM-rate yardstick (one torch.matmul of "
          f"({gmm['routed_rows']}, {OLMOE.d_model}) x ({OLMOE.d_model}, "
          f"{OLMOE.d_ff}) bf16, not the same function): "
          f"{gmm['gemm_ms']:.4f} ms")
    print(f"gmm_f32 library (torch._grouped_mm on the f32 operands): "
          f"{gmm32['library_ms']} ms, max|err| vs plain "
          f"{gmm32['library_err']}")
    for vname, v in gmm["variants"].items():
        if "witness" in v:
            print(f"gmm/{vname} witnesses, max|err| vs plain: {v['witness']}")
    kernels.append(kernel_entry(gmm, "gate_up", moe["launches"]["gmm"]))
    record["kernels"] += bsr + [gmm, gmm32]
    release(device)
    with fault_free("MoE trace mode"):
        moe_trace = moe_trace_path(OLMOE, p, x, device)
    print_trace(moe_trace["trace"], f"MoE ({OLMOE.name}, one sequence)")
    a = moe_trace["autotune"]
    print(f"trace autotune MoE: winner {a['winner']} {a['schedule']}, "
          f"seconds {a['variant_s']}, relative L2 error vs the f32 oracle "
          f"{a['rel_l2']:.3g}")
    print_tune_variants(moe_trace["variants"], "gmm gate_up tm",
                        f"tol atol={GMM_ATOL} + rtol={GMM_RTOL}*|ref|")
    check_moe_trace(moe_trace)
    record["moe_trace"] = moe_trace
    release(device)
    with fault_free("MoE f32"):
        m32 = moe_f32_path(OLMOE, p, x, device)
    print(f"MoE f32 path {OLMOE.name} x {m32['shape']} float32: via "
          f"{m32['selections']}, {m32['steady_call_ms']:.3f} ms "
          f"a block (naive f32 {m32['naive_call_ms']:.3f} ms); relative L2 "
          f"error vs the f32 oracle {m32['rel_l2']:.3g} (naive "
          f"{m32['naive_rel_l2']:.3g}; tol {MOE_F32_RTOL}); K4 launches "
          f"{m32['launches']}")
    check_moe_f32_path(m32)
    kernels.append(kernel_entry(gmm32, "gate_up_f32",
                                m32["launches"]["gmm_f32"]))
    record["moe_f32_path"] = m32

    # -- containment: faults injected on the card ---------------------------
    t0 = time.perf_counter()
    kr = kernel_raise_path(*mats["npb"], x_refs["npb"], device)
    print(f"containment kernel_raise:cuda.ell (npb CG, policy=cuda.ell): "
          f"{kr['fired']} fired, warning {kr['events']}, fallback "
          f"{kr['fallback']}, {kr['plan_hits']} plan hits, containment "
          f"{kr['containment']}, on disk {kr['quarantined']}, "
          f"|x-x_naive|/|x_naive| = {kr['rel_to_naive']:.3g}; a new "
          f"function: {kr['skip_selections']}, "
          f"{kr['skip_containment']['contained_exceptions']} contained, "
          f"{kr['skip_containment']['quarantine_skips']} quarantine skips "
          f"({len(kr['skip_events'])} warned), {kr['skip_launches']} K1 "
          f"launches; store cleared: "
          f"{kr['cleared_selections']}, K1 staged launches "
          f"{kr['cleared_launches']}, |x-x_naive|/|x_naive| = "
          f"{kr['cleared_rel_to_naive']:.3g}")
    check_kernel_raise_path(kr)
    no = nan_output_path(mats["hpcg"][0], args.seed, device)
    print(f"containment nan_output:cuda.bcsr (GNN, {CONTAIN_GNN_STEPS} "
          f"steps): {no['fired']} fired, selections {no['selections']}, "
          f"containment {no['containment']}, |H-H_naive|/|H_naive| = "
          f"{no['rel_to_naive']:.3g} (tol {GNN_RTOL})")
    check_nan_output_path(no)
    sh = shadow_path(mats, x_refs["npb"], OLMOE, p, x, device)
    print(f"shadow rate 1: npb CG {sh['npb']['info']['containment']}, "
          f"{sh['npb']['steady_call_ms']:.3f} ms a call with its check, "
          f"|x-x_naive|/|x_naive| = {sh['npb']['rel_to_naive']:.3g}; MoE "
          f"{sh['moe']} (blocks with their checks, ms)")
    print(f"shadow_diverge:dispatch (hpcg BCSR CG): {sh['bcsr']}")
    check_shadow_path(sh)
    del p, x
    release(device)
    chaos = chaos_path(mats, args.seed, device, work)
    for name, r in chaos["sweep"]["problems"].items():
        print(f"chaos {name}: {r}")
    print(f"chaos (policy=autotune, {chaos['spec']}) in "
          f"{chaos['seconds']:.1f}s: fired={chaos['sweep']['faults_fired']} "
          f"quarantines={chaos['sweep']['quarantines']} "
          f"fallbacks={chaos['sweep']['fallbacks']} persisted="
          f"{chaos['quarantine_records_on_disk']}; "
          + ", ".join(f"{g} {chaos[g]}" for g in (
              "zero_uncontained_exceptions", "results_match_oracle",
              "quarantines_persisted"))
          + f"; replay: {chaos['repro']}")
    check_chaos_path(chaos)
    print(f"containment phase {time.perf_counter() - t0:.1f}s")
    record.update(kernel_raise=kr, nan_output=no, shadow=sh, chaos=chaos)
    # the same calls at commit 199bd38, before containment (NVIDIA H100
    # 80GB HBM3, 700 W): what the validation's sync may add to
    at_parent = {"npb cuda.ell": (0.188, 0.836),
                 "hpcg cuda.ell": (0.200, 0.753),
                 "hpcg cuda.bcsr": (0.212, 0.526)}
    print("cost of containment, fault-free CG calls (timed ms, plan / "
          "bake=False; at 199bd38 beside): " + "; ".join(
              f"{k} {plans[k + ' bake=True']['steady_call_ms']:.3f} / "
              f"{plans[k + ' bake=False']['steady_call_ms']:.3f} "
              f"(199bd38 {v[0]} / {v[1]})" for k, v in at_parent.items()))

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
