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
   * the How language's lifecycle (K1), on the same NPB-C matrix: a
     HARNESS block with ``persistent layout``, BeforeFirstExecution
     (registered with @lilac.hook) and AfterLastExecution (hooks=) on a
     fresh registry, whose setup puts a ReadObject in the state
     (construct: K1's staged layout of the matched CSR; update: a re-pack
     on a change of the values; destruct: let it go) and whose body runs
     K1 on it; 25 CG iterations through it in host mode: setup and
     construct once, no update, 26 launches of K1's staged body, the
     iterate within 1e-3 of the naive CG, no plan (plan_info names the
     hooks); val scaled in place: one update and the CG on the edited
     matrix; register(..., override=True) tears it down once, and device
     memory returns to its level before setup; enabled=False returns the
     function's own bits with no detection and no launch; CompileOptions
     gives the keyword form's bits, selection and baking; the call times
     of the hook-bearing harness, the baked cuda.ell plan and the
     ReadObject's change check;
   * scans (K1, K2), on the same matrices: the CG above written as one
     torch scan (x0, r0, p0, then 25 steps over the naive SpMV, its dot
     products detected too) and compiled whole in host mode with
     policy="cuda.ell": one top-level spmv_csr match and one scan_body
     holding another, 26 launches of K1's staged body (NPB-C) or K2
     (HPCG) a call (counted, and by the profiler), 2 detections and one
     repack on the first call and none on the second, no plan and no
     plan-cache record, the iterate within 1e-3 of the per-iteration CG's
     and of the uncompiled scan's, and the ms of one solve of the compiled
     scan, the per-iteration CG (baked) and the uncompiled scan; then the
     ELL layer iterated 8 times in a scan on NPB-C's ELL in trace mode:
     one torch.ops.higher_order.scan in the rewritten graph whose body
     holds lilac_torch::spmv_ell (K1's direct body, launched once each
     time torch's eager scan calls the step: 9 times for 8 steps on torch
     2.11, whose first call only infers the outputs' shapes), equal to
     host mode and within the kernel tolerance of the uncompiled scan;
   * torch.func.vmap over compiled functions, on the same matrices: the
     CG above over 8 right-hand sides at once (the naive SpMV written out
     of place, compiled in host mode with policy="cuda.ell"): the first
     vmapped call bakes a batched plan (the program traced once under
     torch.func.vmap on the tensors below the batch level, its CUDA graph
     or its eager run, as its timing decides), and the second vmapped
     solve is 26 of 26 plan hits with 26 launches of K1's staged body
     (NPB-C) or K2 (HPCG), each for all 8 vectors (counted, and by the
     profiler), no repack and no detection, while solo calls afterwards
     hit their own plan; each iterate against its solo compiled CG (1e-5,
     or twice the uncompiled CG's own vmapped-against-solo spread: torch's
     vmap of torch.dot rounds apart from torch.dot) and against the
     vmapped uncompiled CG (1e-3); one vmapped solve on plans timed beside
     the unplanned vmapped solve (bake=False) and 8 solo solves on plans;
     the ELL layer over 8 vectors in trace mode (one K1 direct launch a
     call, the second call a plan hit, equal to host mode); the cuda.bcsr
     SpMV over 8 vectors at HPCG (one K3 narrow launch, the vectors as its
     operand's columns, within 1e-4 of the plain version; the second call
     a plan hit, equal to the first bit for bit); for each, one
     batched launch at B = 8 against its 8 solo launches (bit for bit)
     and the plain version, timed beside them with its bound (the stored
     entries once, the 8 vectors and outputs) and its share;
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
     compiles it, under torch.func.vmap over the sequences as the
     reference vmaps it — under the default policy: one moe_ffn/MOE match
     traced once, cuda.gmm as the custom op lilac_torch::moe_ffn, whose
     vmap rule runs both sequences' tokens as one call: 3 launches; the
     next call is a hit on the batched plan the first baked, 3 launches,
     each token's row bit for bit the first call's (the per-sequence loop
     it replaced, run after for comparison only, makes 6 and must give the
     same bits), and the output and the naive bf16
     block's, each as relative L2 error against the f32 plain oracle on
     the same bf16 inputs; K4's gate/up product over both sequences'
     routed rows timed against the two sequences' launches, each token's
     row bit for bit;
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
   * a compiled function inside a user's torch.compile (inductor), after
     the plan phase: NPB-C's ELL layer (relu + bias) in trace mode on
     cuda.ell inside torch.compile(step, fullgraph=True) with the user's
     own elementwise work around it (K1's direct body once a call from
     the compiled program, the entry baked under the trace and the next
     eager call a plan hit, an in-place edit seen); the MoE phase's OLMoE
     block (2 x 4,096 bf16 tokens) with its router and residual inside
     torch.compile(fullgraph=True) (K4's bf16 body 3 times a call, against
     the f32 oracle within 2e-2), then one forward and backward of it
     compiled, its gradients within 2e-2 of the uncompiled step's; and
     NPB-C's CG step around the host-mode cuda.ell SpMV inside
     torch.compile (a graph break: 26 launches of K1's staged body from the
     plan, the iterate within 1e-3 of the naive CG, an in-place edit of the
     values repacked and seen); at most one detection each (none where
     the run's plan cache holds the signature) and none after the first
     call, the compile seconds and the steady ms of each step (CUDA
     events, median of 10) beside the same step run eagerly around the
     call on its plan;
   * gradients, on the same matrices: (sum of squares of the NPB-C SpMV)
     differentiated through lilac.compile(naive SpMV, mode="host") under
     the default policy and cuda.ell (K1 staged forward, the backward its
     ``vjp spmv_csr_bwd`` clause's body); the same loss's
     torch.func.grad compiled (the forward SpMV and the SpMVᵀ detected,
     both on cuda.ell, the third call from a baked plan, its ms beside
     bake=False's); one GNN step's gradient at HPCG x 128 (K3 wide,
     ``vjp spmm_csr_bwd``, the relu epilogue unfused); the ELL layer's
     gradient in trace mode (K1 direct, lilac_torch::spmv_ell's formula,
     the epilogue unfused in the graph of a grad call and fused in the
     other's): each gradient within 1e-4 of its scale (max |ref|) plus
     1e-4 of itself of the uncompiled program's autograd, with launches,
     selections and ms;
   * RWKV-6 1.6B at full width, depth cut from 24 to RWKV_LAYERS = 6
     (d_model 2,048, 32
     heads of 64, d_ff 7,168, vocab 65,536, bf16 from --seed): prefill on
     2 x 512 tokens and 16 teacher-forced decode steps against the
     forward over the 528 tokens (f32: relative L2 within 1e-3 at every
     step; bf16: the decode no further from the f32 forward than twice
     the bf16 forward is, each step's argmax agreement printed), each
     layer's decode against its forward on the layer's own inputs
     (relative L2 within 3e-3 in bf16, 1e-3 in f32) and the bf16
     residual stream's distance from f32's after each layer, prefill
     and decode-step ms, and build_engine("rwkv6-1.6b", smoke=False)
     serving 4 requests: what lilac.compile detects in its decode step,
     every signature baked, and each stream equal to the uncompiled decode
     teacher-forced at the engine's bucket;
   * HuBERT-xlarge (48 layers, d_model 1,280, 16 heads of 80, attention
     both ways) and InternVL2-2B (24 layers, d_model 2,048, 16 heads on 8
     kv heads) at full width and depth from --seed, each fed 2 x 512
     precomputed embeddings (their stub frontends): one bf16 and one f32
     forward (ms, finite logits, the bf16 logits' relative L2 from the f32
     ones), whether changing the last embedding moves the first
     position's output (it must for HuBERT and must not for InternVL2),
     and InternVL2's prefill on the embeddings and one decode step of a
     token through its embedding table; no kernel runs here, nor in the
     reference;
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
     tolerance; a vmapped call is shadowed an element at a time, so each
     block counts its 2 sequences) with no divergence, and
     shadow_diverge:dispatch on the
     BCSR CG: the naive answer served, the plan torn down, cuda.bcsr
     quarantined and the next call without it; the combined fault spec of
     tools/chaos_smoke_torch.py under policy="autotune" at NPB-C and HPCG
     (seeded by --seed; zero uncontained exceptions, results equal to the
     uncompiled program's, quarantines persisted); and the fault-free plan
     and bake=False CG calls beside those of commit 199bd38;
   * training, in a process of its own (deterministic algorithms, cuBLAS's
     workspace fixed): OLMoE-1B-7B at full width (d_model 2048, 16 heads,
     64 experts of d_ff 1024, top-8, vocab 50,304, bf16 parameters, f32
     AdamW master) with its depth cut from 16 to TRAIN_LAYERS = 1 layer,
     moe_impl="lilac"
     (the expert layer of each sequence in trace mode on cuda.gmm, its
     backward ``moe_ffn_bwd``), SyntheticLM at batch 2 x seq 1,024: the
     first step's loss and every gradient leaf against moe_impl="naive"
     from the same parameters and batch (1e-2 and relative L2 2e-2), the
     token-expert pairs past the reference's backward capacity (twice the
     mean load; the port's backward drops none), 4 steps of
     train_loop on its inductor-compiled step (train.loop.compile_step:
     one graph, no break, compiled once; its compile seconds, steady ms
     a step, graph breaks and peak memory) with a checkpoint every 2, a
     restart from step 2 on the same graph whose losses must equal the
     uninterrupted run's bit for bit, K4's 3 x layers launches a step
     from inductor's program (the MoE block vmaps the batch's sequences
     into one call), the compiled first loss within 1e-2 of the
     uncompiled step's and the naive step's; 2 steps of the same step
     uncompiled with their CUDA-event ms, loss, grad norm, peak memory
     and the compiled MoE's plan hits (from step 2 each layer's MoE call
     is a hit on a gradient-carrying batched plan, run eagerly) beside 2
     steps of the unplanned route (the MoE's plans dropped and baking
     off: the planned steps' loss and grad norm within 1e-2 and 2e-2 of
     its) and 3 steps of the naive model, and one compiled and one
     uncompiled lilac step under torch.profiler (device time by kernel
     class, the top kernels, the device's idle share);
   * serving, in a process of its own (cuBLAS's workspace fixed):
     OLMoE-1B-7B at full width, depth cut from 16 to SERVE_LAYERS = 2
     (bf16 parameters from --seed, moe_decode_impl="naive_flat") in
     repro_torch.serve's Engine
     (continuous batching, host-mode lilac on the decode step, baked
     plans) over the bucket grid batch (1, 8) x seq (256, 512): prewarm
     bakes the four signatures (seconds each) and compiles the prefill
     (aot_eager) at each prompt length of the grid (64, 200), the
     cache-row install and the slot move at each bucket (jit_prefill),
     then a closed burst of 8 SyntheticWorkload requests (prompts from
     that grid, 16-64 new tokens; the first workload seed from --seed
     whose burst needs both seq buckets and ends in the smaller) runs
     with no detection, no bucket miss and no compile on the request
     path, one moe_ffn match a layer
     on cuda.gmm in every plan and K4 launched 3 x 2 times a decode step;
     prints TTFT, prefill and decode-step percentiles, tokens/s, peak
     memory, each bucket's plan (CUDA graph or eager, the bytes a replay
     copies, captures), one decode step under torch.profiler; checks each
     MoE layer of one compiled bf16 decode step (cuda.gmm) against the
     naive dense dispatch on the layer's own input (relative L2 2e-2),
     and two streams teacher-forced (16 steps) through the compiled and
     the uncompiled decode (bf16 against the uncompiled decode computing K4's
     function, 2e-2; f32 against the naive one, 1e-4; the prefill's first
     tokens equal); the engine's default prefill (inductor) of the model
     cut to SERVE_INDUCTOR_LAYERS = 1 layer at the burst's first prompt
     length, compiled apart as one graph, its logits on two prompts
     within 2x the eager prefill's relative L2 from the f32 oracle (at
     least 2e-2) of the eager prefill's (its compile seconds, ms beside the
     eager prefill's, the top-2 margins and, where a greedy token differs,
     the gap between the two tokens printed),
     prints each stream against a fresh engine's solo run and, where they
     part, the step and the first operator whose row differs, and requires
     0 divergences of the request shadow at rate 1 (replays at the batched
     buckets); runs the burst on an uncompiled engine; under decode_raise
     and decode_nan the poisoned slots leave with their reason and the
     survivors' streams equal the fault-free run's; a second replica's
     prewarm detects nothing, and replica_crash on the two-replica
     FrontDoor loses no request, with the streams of the fault-free run;
     shadow_diverge:request quarantines cuda.gmm and the next decode runs
     without it; moe_ffn_ragged on K4 at 1, 7, 33 and 200 tokens and the
     padded baseline within relative L2 2e-2 of the f32 oracle; and K4 at
     the decode shapes (T = 1 and 8 tokens x top-8) in the kernels line;
   * serving granite-moe-3b-a800m, in a process of its own: full width,
     depth cut from 32 to GRANITE_SERVE_LAYERS = 2 layers (d_model
     1,536, 24 heads on 8 kv heads, 40 experts of d_ff 512, top-8, vocab
     49,155, bf16 from --seed) through the same phase and checks on the
     same grid (2 moe_ffn matches a signature, K4 3 x 2 times a decode
     step, each MoE layer of one
     compiled step against the naive dispatch, teacher-forced in bf16 and
     f32, the request shadow at rate 1), without the model-independent
     runs that OLMoE's phase makes (batched against solo, the faults, the
     second replica, moe_ffn_ragged), and K4's gate/up and down products
     at T = 1 and 8 in the kernels line;
   * serving Jamba-v0.1, in a process of its own: full width (d_model
     4,096, 32 heads on 8 kv heads of 128, 16 experts of d_ff 14,336,
     top-2, d_state 16, vocab 65,536, bf16 from --seed) with its depth cut
     from 32 to JAMBA_LAYERS = 8 layers (one 8-layer period of 1 attention
     and 7 Mamba layers, MoE on the 4 odd layers; the whole model is
     103 GB), through granite's phase and checks (4
     moe_ffn matches on cuda.gmm a signature and no other match, K4 3 x 4
     times a decode step) but for the f32 teacher-forced comparison,
     which runs after the bf16 model is freed at one period (8 layers,
     53.2 GB in f32: the compiled decode on K4's f32 body against the
     naive one, 1e-4); on the same bf16 parameters, each layer's residual
     stream against an f32 copy's (its parameters cast a block at a time)
     and each of the 14 Mamba layers' decode against its forward on the
     layer's own inputs over 32 steps after a 512-token prefill (relative
     L2 within 2e-3 in bf16, 1e-3 in f32), and the whole bf16 decode
     against the bf16 forward over the longer sequence (printed); K4's
     gate/up and down at T = 1 and 8 (top-2 of 16: Tp 2,048 rows, with
     the used and tail row tiles) in the kernels line;
   * distributed training, in four processes of their own under
     ``torch.distributed.run`` (gloo; all four ranks on this one card, so
     every collective copies its operand to the host and back): the
     training phase's OLMoE-1B-7B (full width, TRAIN_LAYERS layers, bf16,
     moe_impl="lilac", its parameters and batch) on a (data 2, model 2)
     mesh with sequence parallelism (FSDP over data; tensor parallelism
     over model for attention and the vocabulary; each rank's 32 of the
     64 experts through lilac.compile's naive dispatch, K4 over the local
     experts, other ranks' pairs at gate 0, the partial sums reduced over
     model): the first step's loss against each rank's one-device step on
     the same parameters and batch (1e-2) and every gradient leaf over
     the mesh (relative L2 2e-2), the tokens whose top-k differs from the
     one-device step's, each MoE layer against the naive dispatch on the
     same input (2e-2), one K4 launch on each rank's experts against its
     plain version, K4 launched on every rank in its step
     (ms, loss, grad norm, collective payload, peak memory), 1 step of
     the same mesh step compiled (aot_eager; the host-staged collectives
     and torch.autograd.grad are graph breaks, counted; the first loss
     within 1e-2 of the uncompiled step's, K4 launched as there), and the
     initial parameters saved from the mesh and restored onto a (4, 1)
     mesh and onto one device bit for bit;
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
import difflib
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
# K4 summing more products than that (Jamba: 4,096 and 14,336) of the
# model's init scale, outputs up to ~2e4: two f32 orders of such a sum part
# by more than GMM_ATOL + GMM_RTOL*|ref| where the sum crosses zero (two
# CPU orders of the down product by 0.014, scaled 1.13), so there the
# tolerance is the sum's own scale, |K4 - plain| <= GMM_ATOL +
# GMM_SUM_RTOL * (|x| @ |w|) (the accumulated |terms|): 2^-16 of it, far
# below a wrong expert's or a lost 64-product step's error
GMM_SUM_RTOL = 2.0 ** -16
GMM_SUM_MIN_K = 2048
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


def cuda_ms(fn, reps: int, median: bool = False):
    """(device ms, host ms) per call of ``fn`` over ``reps`` back-to-back
    calls, after one warm-up call: the device time from CUDA events, the
    host time to enqueue them.  Where the host takes as long as the
    device, the events time the host's gaps, not the kernel.  With
    ``median``, each call runs between its own events and is waited for,
    and the medians of the ``reps`` calls come back."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if median:
        dev, host = [], []
        for _ in range(reps):
            t0 = time.perf_counter()
            start.record()
            fn()
            end.record()
            host.append(1e3 * (time.perf_counter() - t0))
            end.synchronize()
            dev.append(start.elapsed_time(end))
        return sorted(dev)[reps // 2], sorted(host)[reps // 2]
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, 1e3 * host / reps


def profiled_ms(fn, reps: int, kernel: str) -> dict:
    """torch.profiler over ``reps`` calls of ``fn``, after two calls in its
    warm-up steps (the profiler can miss the first launches of its window
    otherwise; after one it once saw 24 of a solve's 26 replayed
    launches): ``ms``, the mean device time per launch of the CUDA
    kernels whose name holds ``kernel``; ``launches``, their launches a
    call; and ``device_ms``, the device time of every kernel a call (each
    None where the profiler records no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    got: list = []
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        # the profiler's "clears events" notice, and no other warning
        warnings.filterwarnings("ignore", message=".*clears events")
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=2, active=reps,
                                       repeat=1),
                     on_trace_ready=lambda p: got.extend(
                         p.key_averages())) as prof:
            for _ in range(reps + 2):
                fn()
                torch.cuda.synchronize()
                prof.step()
    events = [e for e in got if e.count and e.device_time_total > 0]
    ours = [e for e in events if kernel in e.key]
    return {"ms": sum(e.device_time_total / e.count for e in ours) / 1e3
            if ours else None,
            "launches": sum(e.count for e in ours) / reps if ours else None,
            "device_ms": sum(e.device_time_total for e in events) / 1e3 / reps
            if events else None}


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
                    dtype, atol=KERNEL_ATOL, rtol=KERNEL_RTOL, what="",
                    sum_scale=None):
    """Hold ``run()`` against ``plain()`` and time both: the numbers of one
    kernel variant.  With ``sum_scale`` (each output's accumulated
    |terms|) the tolerance is atol + GMM_SUM_RTOL * sum_scale, not
    atol + rtol * |ref|."""
    got = run()
    want = plain()
    if on_card:
        import torch
        torch.cuda.synchronize()
    err, scaled = max_err(got, want, atol, rtol)
    tol = f"atol={atol} + rtol={rtol}*|ref|"
    if sum_scale is not None:
        diff = (got.float() - want.float()).abs()
        scaled = float((diff / (atol + GMM_SUM_RTOL * sum_scale)).max())
        tol = f"atol={atol} + {GMM_SUM_RTOL:.3g}*(|x|@|w|)"
    require(scaled <= 1.0, f"{what}: max |err| {err:.3g} within {tol}")
    del got, want
    b_ms, b_by = bound_ms(nb, flops, dtype)
    ms, host_ms = cuda_ms(run, reps) if on_card else (None, None)
    prof_ms = profiled_ms(run, max(2, reps // 2), kernel_name)["ms"] \
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
    """One expert layer through moe_block(impl='lilac') (the compiled MoE
    under ``torch.func.vmap`` over the sequences), then the naive block,
    each against the f32 plain oracle; ``launches`` counts each K4 body's
    launches in the first call, which bakes a batched plan, and
    ``plan_launches`` those of the second, which the plan serves (each
    token's row bit for bit the first call's).  For comparison only,
    after the counts are read: the compiled MoE called on each sequence
    in a loop, as the block ran it before it vmapped."""
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
    hits = fast.plan_info()["plan_hits"]
    G.reset_launches()
    planned, _ = L.moe_block(p, x, topk=cfg.moe_topk, impl="lilac")
    sync(device)
    info = fast.plan_info()
    res = {"plan_launches": dict(G.LAUNCHES),
           "plan_hits": info["plan_hits"] - hits,
           "plan_equal": bool(torch.equal(out, planned)),
           "plans": [{k: q[k] for k in ("transform", "runs", "eager_reason",
                                         "replay_ms", "eager_ms")}
                     for q in info["plans"]],
           "match": (m.computation, m.format),
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
    G.reset_launches()

    def per_sequence():
        return torch.stack([fast(x[b], gate[b], idx[b], p["wg"], p["wu"],
                                 p["wd"]) for b in range(x.shape[0])])

    loop = per_sequence()
    sync(device)
    res["loop_launches"] = dict(G.LAUNCHES)
    calls = []
    for _ in range(3):
        timed(per_sequence, calls, device)()
    res["loop_call_ms"] = 1e3 * sorted(calls)[1]
    res["loop_equal"] = bool(torch.equal(out, loop))
    res["rel_to_loop"] = rel_l2(out, loop)
    res["bake_errors"] = fast.plan_info()["bake_errors"]
    del planned
    return res


def moe_batched_numbers(cfg, p, x, device, reps: int = 10) -> dict:
    """K4's gate/up product as the vmapped block runs it, over both
    sequences' routed rows at once, against the same product a sequence
    at a time (each token's row bit for bit) and the plain version, timed
    with its bound (the weights once, the routed rows in and out)."""
    import torch
    from repro_torch.kernels.moe_gmm import kernel as G
    from repro_torch.kernels.moe_gmm import ref as GR
    from repro_torch.kernels.moe_gmm.ops import _route
    from repro_torch.models import layers as L

    gate, idx, _ = L.moe_router(p, x, cfg.moe_topk)
    E, D, F = p["wg"].shape
    K, tm = idx.shape[-1], 128

    def routed(tokens, ids):
        dest, te, tp = _route(ids, ids.shape[0], K, E, tm)
        xs = torch.zeros((tp, D), dtype=x.dtype, device=device).index_put(
            (dest,), tokens.repeat_interleave(K, dim=0))
        return xs, te, dest

    xs, te, dest = routed(x.reshape(-1, D), idx.reshape(-1, K))
    solo = [routed(x[b], idx[b]) for b in range(x.shape[0])]
    rows = dest.shape[0]
    res = batched_numbers(
        lambda: G.gmm_cuda(xs, p["wg"], te, tm)[dest],
        lambda: torch.cat([G.gmm_cuda(s, p["wg"], t, tm)[d]
                           for s, t, d in solo]),
        lambda: GR.gmm_ref(xs, p["wg"], te, tm)[dest],
        "gmm_tc_kernel", device.type == "cuda", reps,
        rows * D * x.element_size() + nbytes(p["wg"]) + rows * F * 4,
        2 * rows * D * F, x.dtype, GMM_ATOL, GMM_RTOL,
        what="vmap gmm gate_up")
    res.update(routed_rows=rows, tp=xs.shape[0],
               solo_tp=[s.shape[0] for s, _, _ in solo], library_ms=None)
    return res


def check_moe_path(res, batch: int = MOE_BATCH) -> None:
    require(res["match"] == ("moe_ffn", "MOE"),
            f"MoE: one moe_ffn/MOE match, got {res['match']}")
    require(res["traces"] == 1, f"MoE: one trace for {batch} sequences, got "
            f"{res['traces']}")
    require(res["selections"] == ["cuda.gmm"],
            f"MoE: cuda.gmm under the default policy, got "
            f"{res['selections']}")
    require(res["launches"] == {"gmm": 3, "gmm_f32": 0},
            f"K4's bf16 body launched 3 times for the {batch} sequences "
            f"(vmapped: one moe_ffn over their tokens), got "
            f"{res['launches']}")
    require(res["loop_launches"] == {"gmm": 3 * batch, "gmm_f32": 0}
            and res["loop_equal"],
            f"MoE: the vmapped block equal bit for bit to the compiled MoE "
            f"called a sequence at a time ({3 * batch} launches), got "
            f"{res['loop_launches']}, relative L2 {res['rel_to_loop']:.3g}")
    require(res["plan_hits"] == 1 and res["plan_equal"]
            and res["plan_launches"] == {"gmm": 3, "gmm_f32": 0}
            and not res["bake_errors"]
            and any(q["transform"] and q["transform"]["vmap"]
                    for q in res["plans"]),
            f"MoE: the second vmapped block served by its batched plan with "
            f"3 K4 launches, each token's row bit for bit the unplanned "
            f"call's, got {res['plan_hits']} hits, launches "
            f"{res['plan_launches']}, equal {res['plan_equal']}, plans "
            f"{res['plans']}, bake_errors {res['bake_errors']}")
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
                   timeout: int = 600, **env_vars) -> dict:
    """A second process of this script on the store (``flag`` picks what
    it runs; ``env_vars`` set its environment)."""
    env = dict(os.environ, LILAC_TORCH_AUTOTUNE_CACHE=str(store),
               **env_vars)
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--seed", str(seed), flag], env=env,
                       capture_output=True, text=True, timeout=timeout)
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
# A compiled function inside a user's torch.compile (K1 direct, K1 staged, K4)
# ---------------------------------------------------------------------------

USER_COMPILE_CALLS = 10        # steady calls of each compiled step timed


def user_compile_path(mats, x_ref, cfg, seed: int, device) -> dict:
    """Compiled functions called inside a user's ``torch.compile`` (the
    default inductor backend), the reference's user ``jax.jit`` row:

    * ``ell``: NPB-C's ELL layer (relu + bias) compiled in trace mode with
      policy="cuda.ell", inside ``torch.compile(fullgraph=True)`` with the
      user's own elementwise work around it: the call is one opaque node
      that AOT autograd traces, so ``lilac_torch::spmv_ell`` (K1 direct
      with the fused epilogue) runs from the compiled program, once a
      call; the entry bakes under the trace and the next eager call is a
      plan hit, which takes the deferred CUDA-graph capture;
    * ``moe``: the MoE phase's OLMoE block (``moe_block(impl="lilac")``,
      the compiled MoE under ``torch.func.vmap``) with its router and the
      residual inside ``torch.compile(fullgraph=True)``: K4's bf16 body 3
      times a call from the compiled program; then one forward and
      backward of the same step compiled, its gradients against the
      uncompiled step's;
    * ``cg``: NPB-C's CG step around the host-mode cuda.ell SpMV inside
      ``torch.compile`` (no fullgraph): a graph break at the call, which
      runs concretely on its plan (K1 staged, 26 launches a solve); an
      in-place edit of the values between two compiled calls is seen.

    Each compiled step's first call (the compile) on the host's clock, its
    steady ms beside the same step run eagerly around the compiled
    function on its plan, its launches and its values.  A signature
    detects at most once, and not at all where an earlier phase's record
    in the run's plan cache serves it (the CG's SpMV)."""
    import torch
    from repro_torch import lilac
    from repro_torch.kernels.moe_gmm import kernel as G
    from repro_torch.kernels.moe_gmm import ref as GR
    from repro_torch.kernels.spmv_ell import kernel as K
    from repro_torch.models import layers as L
    from repro_torch.sparse import ell_from_csr

    torch._dynamo.reset()
    res = {}
    a, b = mats["npb"]
    calls = USER_COMPILE_CALLS

    def ms(fn):                 # the median device ms of one call
        return cuda_ms(fn, calls, median=True)[0]

    # -- the ELL layer, fullgraph -------------------------------------------
    ell = ell_from_csr(a, lane=128)
    gen = torch.Generator(device="cpu").manual_seed(seed + 5)
    vec = torch.randn(a.cols, generator=gen).to(device)
    bias = torch.randn(a.rows, generator=gen).to(device)
    layer = lilac.compile(ell_layer, device=device, policy="cuda.ell")

    def ell_step(val, col, v, bias):
        return torch.tanh(layer(val, col, v * 0.5, bias)) + 1

    def ell_plain(val, col, v, bias):
        return torch.tanh(ell_layer(val, col, v * 0.5, bias)) + 1

    args = (ell.val, ell.col, vec, bias)
    step = torch.compile(ell_step, fullgraph=True)
    K.reset_launches()
    first_s: list = []
    y = timed(step, first_s, device)(*args)
    first = dict(K.LAUNCHES)
    traced = layer.plan_info()
    detects = layer.stats["detects"]
    K.reset_launches()
    for _ in range(calls):
        step(*args)
    steady = dict(K.LAUNCHES)
    want = ell_plain(*args)
    eager = ell_step(*args)             # the plan's first concrete call
    info = layer.plan_info()
    r = {"compile_s": first_s[0], "first_launches": first,
         "launches": steady, "calls": calls,
         "max_abs_err": max_err(y, want)[0],
         "within_tol": max_err(y, want)[1] <= 1.0,
         "eager_within_tol": max_err(eager, want)[1] <= 1.0,
         "detects": detects, "detects_after": layer.stats["detects"],
         "baked_under_trace": traced["baked"],
         "traced_calls": traced["traced_calls"],
         "bake_errors": info["bake_errors"],
         "plan_hits": info["plan_hits"], "rebakes": info["rebakes"],
         "plan": {k: info["plans"][0][k] for k in (
             "runs", "eager_reason", "trace_serves", "capture_deferred")}
         if info["plans"] else None,
         "selections": [n for _, n in layer.last_selections],
         "ms": ms(lambda: step(*args)),
         "eager_ms": ms(lambda: ell_step(*args))}
    val = ell.val.clone()
    step(val, ell.col, vec, bias)
    val.mul_(2)
    got = step(val, ell.col, vec, bias)
    r["edit_within_tol"] = max_err(got, ell_plain(val, ell.col, vec,
                                                  bias))[1] <= 1.0
    res["ell"] = r
    del ell, val, got, want, eager, y, layer, step
    release(device)

    # -- the OLMoE block, fullgraph; then forward and backward --------------
    p, x = moe_inputs(cfg, seed, device)
    L._LILAC_MOE.clear()

    def moe_step(p, x):
        out, aux = L.moe_block(p, x, topk=cfg.moe_topk, impl="lilac")
        return x + out, out, aux

    step = torch.compile(moe_step, fullgraph=True)
    G.reset_launches()
    first_s = []
    y, out, aux = timed(step, first_s, device)(p, x)
    first = dict(G.LAUNCHES)
    fast = L._lilac_moe_2d(device.type)
    traced = fast.plan_info()
    detects = fast.stats["detects"]
    G.reset_launches()
    for _ in range(calls):
        step(p, x)
    steady = dict(G.LAUNCHES)
    gate, idx, _ = L.moe_router(p, x, cfg.moe_topk)
    ref = torch.stack([GR.moe_ffn_ref(x[i], gate[i], idx[i], p["wg"],
                                      p["wu"], p["wd"])
                       for i in range(x.shape[0])])
    eager = moe_step(p, x)
    r = {"compile_s": first_s[0], "first_launches": first,
         "launches": steady, "calls": calls, "shape": tuple(y.shape),
         "finite": bool(torch.isfinite(y).all()),
         "rel_l2": rel_l2(out, ref), "eager_rel_l2": rel_l2(eager[1], ref),
         "rel_to_eager": rel_l2(y, eager[0]),
         "detects": detects, "detects_after": fast.stats["detects"],
         "traced_calls": traced["traced_calls"],
         "selections": [n for _, n in fast.last_selections],
         "ms": ms(lambda: step(p, x)),
         "eager_ms": ms(lambda: moe_step(p, x))}
    info = fast.plan_info()
    r.update(plan_hits=info["plan_hits"], bake_errors=info["bake_errors"])
    del y, out, aux, eager, step
    release(device)
    train = ("router", "wg", "wu", "wd")
    ct = torch.randn(x.shape, generator=torch.Generator(device=device)
                     .manual_seed(seed + 6), device=device)

    def loss_of(p, x):
        return (moe_step(p, x)[0].float() * ct).sum()

    def grads(fn):
        q = {k: v.detach().clone().requires_grad_(k in train)
             for k, v in p.items()}
        loss = fn(q, x)
        loss.backward()
        return float(loss.detach()), [q[k].grad for k in train]

    step = torch.compile(loss_of, fullgraph=True)
    G.reset_launches()
    grad_s: list = []
    loss, got = timed(grads, grad_s, device)(step)
    grad_launches = dict(G.LAUNCHES)
    loss_ref, want = grads(loss_of)
    r.update(grad_compile_s=grad_s[0], grad_launches=grad_launches,
             loss=loss, loss_eager=loss_ref,
             grad_rel_l2={k: rel_l2(g, w)
                          for k, g, w in zip(train, got, want)},
             grads_finite=all(bool(torch.isfinite(g).all()) for g in got),
             detects_after_grad=fast.stats["detects"])
    res["moe"] = r
    del p, x, ct, got, want, step, fast
    L._LILAC_MOE.clear()
    release(device)

    # -- NPB-C's CG step around a host-mode call: a graph break -------------
    spmv = lilac.compile(naive_spmv, mode="host", policy="cuda.ell",
                         device=device)

    def cg_step(val, col, ptr, x, r, p, rs):
        ap = spmv(val, col, ptr, p)
        alpha = rs / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.dot(r, r)
        return x, r, r + (rs_new / rs) * p, rs_new, ap

    step = torch.compile(cg_step)
    K.reset_launches()
    xk = torch.zeros_like(b)
    rk = b - spmv(a.val, a.col_ind, a.row_ptr, xk)
    state = (xk, rk, rk, torch.dot(rk, rk))
    first_s = []
    state = timed(step, first_s, device)(a.val, a.col_ind, a.row_ptr,
                                         *state)[:4]
    detects = spmv.stats["detects"]
    for _ in range(CG_ITERS - 1):
        state = step(a.val, a.col_ind, a.row_ptr, *state)[:4]
    sync(device)
    launches = dict(K.LAUNCHES)
    info = spmv.plan_info()
    r = {"compile_s": first_s[0], "launches": launches,
         "rel_to_naive": rel_l2(state[0], x_ref),
         "finite": bool(torch.isfinite(state[0]).all()),
         "detects": detects, "detects_after": spmv.stats["detects"],
         "plan_hits": info["plan_hits"], "rebakes": info["rebakes"],
         "plan": {k: info["plans"][0][k] for k in ("runs", "eager_reason")}
         if info["plans"] else None,
         "selections": [n for _, n in spmv.last_selections],
         "ms": ms(lambda: step(a.val, a.col_ind, a.row_ptr, *state)),
         "eager_ms": ms(lambda: cg_step(a.val, a.col_ind, a.row_ptr,
                                        *state))}
    val = a.val.clone()
    step(val, a.col_ind, a.row_ptr, *state)
    misses = spmv.cache.stats.misses
    val.mul_(2)
    ap = step(val, a.col_ind, a.row_ptr, *state)[4]
    r["edit_repacks"] = spmv.cache.stats.misses - misses
    r["edit_within_tol"] = max_err(ap, naive_spmv(
        val, a.col_ind, a.row_ptr, state[2]))[1] <= 1.0
    res["cg"] = r
    torch._dynamo.reset()
    return res


def print_user_compile_path(uc, smi: str) -> None:
    e, m, c = uc["ell"], uc["moe"], uc["cg"]
    print(f"user compile ELL layer (npb, trace mode, cuda.ell, "
          f"torch.compile(fullgraph=True), inductor): compiled in "
          f"{e['compile_s']:.2f}s, K1 launches {e['first_launches']} on the "
          f"first call, {e['launches']} over {e['calls']} calls; max|err| vs "
          f"plain {e['max_abs_err']:.3g} (tol atol={KERNEL_ATOL} + "
          f"rtol={KERNEL_RTOL}*|ref|); detects {e['detects']} -> "
          f"{e['detects_after']}; baked under the trace "
          f"{e['baked_under_trace']}, traced calls {e['traced_calls']}, then "
          f"{e['plan_hits']} eager plan hits, {e['rebakes']} rebakes, plan "
          f"{e['plan']}; steady {e['ms']:.4f} ms a step compiled, "
          f"{e['eager_ms']:.4f} ms eager around the call on its plan "
          f"({smi})")
    print(f"user compile OLMoE block (moe_block(impl='lilac') with router "
          f"and residual, torch.compile(fullgraph=True), inductor): compiled "
          f"in {m['compile_s']:.2f}s, K4 launches {m['first_launches']} on "
          f"the first call, {m['launches']} over {m['calls']} calls; "
          f"selections {m['selections']}, relative L2 vs the f32 oracle "
          f"{m['rel_l2']:.3g} (eager {m['eager_rel_l2']:.3g}; tol "
          f"{MOE_RTOL}), the step vs eager {m['rel_to_eager']:.3g}; detects "
          f"{m['detects']} -> {m['detects_after']} -> "
          f"{m['detects_after_grad']}; traced calls {m['traced_calls']}; "
          f"steady {m['ms']:.4f} ms a step compiled, {m['eager_ms']:.4f} ms "
          f"eager around the call on its plan ({smi})")
    print(f"user compile OLMoE block forward+backward: compiled and run in "
          f"{m['grad_compile_s']:.2f}s, K4 launches {m['grad_launches']}, "
          f"loss {m['loss']:.6g} (eager {m['loss_eager']:.6g}), gradients' "
          f"relative L2 vs the uncompiled step's "
          f"{ {k: round(v, 6) for k, v in m['grad_rel_l2'].items()} } (tol "
          f"{TRAIN_GRAD_RTOL})")
    print(f"user compile CG step (npb, host-mode cuda.ell behind a graph "
          f"break, torch.compile, inductor): compiled in "
          f"{c['compile_s']:.2f}s, launches over the solve {c['launches']}, "
          f"|x-x_naive|/|x_naive| = {c['rel_to_naive']:.3g} (tol {CG_RTOL});"
          f" detects {c['detects']} -> {c['detects_after']}; "
          f"{c['plan_hits']} plan hits, {c['rebakes']} rebakes, plan "
          f"{c['plan']}; in-place val.mul_(2): {c['edit_repacks']} repack, "
          f"within tol {c['edit_within_tol']}; steady {c['ms']:.4f} ms a "
          f"step compiled, {c['eager_ms']:.4f} ms eager ({smi})")


def check_user_compile_path(uc, iters: int = CG_ITERS) -> None:
    e, m, c = uc["ell"], uc["moe"], uc["cg"]
    require(e["selections"] == ["cuda.ell"]
            and e["first_launches"]["spmv_ell"] == 1
            and e["launches"] == {"spmv_ell": e["calls"],
                                  "spmv_ell_staged": 0,
                                  "spmv_ell_windowed": 0},
            f"user compile ELL layer: K1's direct body once a call from the "
            f"compiled program, got {e['first_launches']} then "
            f"{e['launches']} over {e['calls']} calls")
    require(e["within_tol"] and e["eager_within_tol"]
            and e["edit_within_tol"],
            f"user compile ELL layer: within the kernel tolerance of the "
            f"plain step, eagerly and after an in-place edit, got max|err| "
            f"{e['max_abs_err']:.3g}")
    require(e["detects"] == e["detects_after"] <= 1
            and e["baked_under_trace"] == 1 and not e["bake_errors"]
            and e["plan_hits"] >= 1 and e["rebakes"] == 0,
            f"user compile ELL layer: at most one detection, a plan baked "
            f"under the trace and hit by the eager calls with no rebake, got "
            f"detects "
            f"{e['detects']} -> {e['detects_after']}, baked "
            f"{e['baked_under_trace']}, {e['plan_hits']} hits, "
            f"{e['rebakes']} rebakes, bake_errors {e['bake_errors']}")
    require(m["selections"] == ["cuda.gmm"]
            and m["first_launches"] == {"gmm": 3, "gmm_f32": 0}
            and m["launches"] == {"gmm": 3 * m["calls"], "gmm_f32": 0}
            and m["grad_launches"] == {"gmm": 3, "gmm_f32": 0},
            f"user compile OLMoE block: K4's bf16 body 3 times a call from "
            f"the compiled program, got {m['first_launches']}, then "
            f"{m['launches']} over {m['calls']} calls, forward+backward "
            f"{m['grad_launches']}")
    require(m["finite"] and m["rel_l2"] <= MOE_RTOL
            and m["eager_rel_l2"] <= MOE_RTOL,
            f"user compile OLMoE block: relative L2 error vs the f32 oracle "
            f"within {MOE_RTOL}, got {m['rel_l2']:.3g} (eager "
            f"{m['eager_rel_l2']:.3g})")
    require(m["grads_finite"] and max(m["grad_rel_l2"].values())
            <= TRAIN_GRAD_RTOL,
            f"user compile OLMoE block: gradients within {TRAIN_GRAD_RTOL} "
            f"of the uncompiled step's, got {m['grad_rel_l2']}")
    require(m["detects"] == m["detects_after"] <= 1
            and m["detects_after_grad"] <= m["detects"] + 1
            and not m["bake_errors"],
            f"user compile OLMoE block: at most one detection a signature, "
            f"got {m['detects']} -> {m['detects_after']} -> "
            f"{m['detects_after_grad']}, bake_errors {m['bake_errors']}")
    require(c["selections"] == ["cuda.ell"]
            and c["launches"]["spmv_ell_staged"] == iters + 1
            and c["launches"]["spmv_ell"] == 0
            and c["launches"]["spmv_ell_windowed"] == 0,
            f"user compile CG step: K1's staged body once an SpMV "
            f"({iters + 1}) behind the graph break, got {c['launches']}")
    require(c["finite"] and c["rel_to_naive"] <= CG_RTOL,
            f"user compile CG step: the iterate within {CG_RTOL} of the "
            f"naive CG, got {c['rel_to_naive']:.3g}")
    require(c["detects"] == c["detects_after"] <= 1
            and c["plan_hits"] >= iters and c["rebakes"] == 0,
            f"user compile CG step: at most one detection and the plan "
            f"serving the calls, got detects {c['detects']} -> "
            f"{c['detects_after']}, "
            f"{c['plan_hits']} hits, {c['rebakes']} rebakes")
    require(c["edit_repacks"] == 1 and c["edit_within_tol"],
            f"user compile CG step: an in-place edit of the values repacks "
            f"once and gives the edited matrix's SpMV, got "
            f"{c['edit_repacks']} repacks, within tol {c['edit_within_tol']}")


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
    two MoE blocks (cuda.gmm, bf16; each block's vmapped call checks its
    sequences) against the uncompiled program, then
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


# ---------------------------------------------------------------------------
# Gradients through the kernels: vjp clauses and the custom ops' formulas
# ---------------------------------------------------------------------------

# dval, dx and the GNN's gradients against the uncompiled program's
# autograd on the card: |got - want| <= 1e-5 * max |want| + 1e-4 * |want|.
# The atol is relative to the gradient's scale: each is an f32 sum of
# hundreds of products taken in another order (atomics, K1's rows),
# through a forward sum that cancels to ~0 in some rows, so an element far
# below the scale carries the scale's rounding (an element-wise 1e-4
# failed on NPB-C's dx by an absolute 0.34 of a 421,813 scale).  The
# readings sit near 1e-6 of the scale, as does the uncompiled program's
# own f32 gradient against its f64 one (the "control" entry).
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4


def grads_of(fn, args, wrt):
    """The gradients of sum(fn(*args)^2) with respect to args[i], i in
    ``wrt``, by autograd (the arguments copied, so no .grad accumulates)."""
    import torch

    args = list(args)
    for i in wrt:
        args[i] = args[i].detach().clone().requires_grad_()
    out = fn(*args)
    loss = ((out if out.dtype == torch.float64 else out.float()) ** 2).sum()
    return torch.autograd.grad(loss, [args[i] for i in wrt])


def grad_errors(got, want) -> dict:
    """Per gradient: max |err|, the gradient's scale (max |want|) and
    whether every element is within GRAD_ATOL of the scale plus
    GRAD_RTOL of itself."""
    scale = [float(w.float().abs().max()) for w in want]
    errs = [max_err(g, w, GRAD_ATOL * s, GRAD_RTOL)
            for g, w, s in zip(got, want, scale)]
    return {"max_abs_err": [e[0] for e in errs], "scale": scale,
            "within_tol": all(e[1] <= 1.0 for e in errs)}


def grad_path(mats, seed: int, device, reps: int = 5) -> dict:
    """The gradient paths on the card: grad-of-compile of the NPB-C SpMV
    under the default policy and cuda.ell (K1 staged, ``vjp
    spmv_csr_bwd``), compile-of-grad of the same loss (two matches, a plan
    from its third call, against bake=False), one GNN step's gradient at
    HPCG x 128 (K3 wide, ``vjp spmm_csr_bwd``, the epilogue unfused), and
    the ELL layer's gradient in trace mode (K1 direct, the formula of
    ``lilac_torch::spmv_ell``, the epilogue unfused)."""
    import torch
    from repro_torch import lilac
    from repro_torch.kernels.bsr_spmm import kernel as B
    from repro_torch.kernels.spmv_ell import kernel as K
    from repro_torch.sparse import ell_from_csr

    def ms(fn, reps):
        """(device ms, host ms) a call on the card; not measured here."""
        return cuda_ms(fn, reps) if device.type == "cuda" else None

    gen = torch.Generator(device="cpu").manual_seed(seed + 5)
    a = mats["npb"][0]
    x = torch.randn(a.cols, generator=gen).to(device)
    args = (a.val, a.col_ind, a.row_ptr, x)
    want = grads_of(naive_spmv, args, (0, 3))
    exact = grads_of(naive_spmv, (a.val.double(), a.col_ind, a.row_ptr,
                                  x.double()), (0, 3))
    res = {"npb naive fwd+bwd ms": ms(
        lambda: grads_of(naive_spmv, args, (0, 3)), reps),
        "npb control: naive f32 against naive f64": grad_errors(want, exact)}
    del exact
    for policy in ("default", "cuda.ell"):
        fast = lilac.compile(naive_spmv, mode="host", policy=policy,
                             device=device)
        K.reset_launches()
        got = grads_of(fast, args, (0, 3))
        launches = dict(K.LAUNCHES)
        res[f"npb grad-of-compile {policy}"] = {
            "selections": [n for _, n in fast.last_selections],
            "launches": launches, **grad_errors(got, want),
            "fwd+bwd ms": ms(lambda: grads_of(fast, args, (0, 3)),
                                  reps),
            "bake_errors": fast.plan_info()["bake_errors"]}
        del fast
    release(device)

    def loss(v, c, r, xx):
        return (naive_spmv(v, c, r, xx) ** 2).sum()

    grad = torch.func.grad(loss, argnums=(0, 3))
    want = grad(*args)
    cog = lilac.compile(grad, mode="host", policy="cuda.ell", device=device)
    interp = lilac.compile(grad, mode="host", policy="cuda.ell",
                           device=device, bake=False)
    K.reset_launches()
    first_s = []
    got = timed(cog, first_s, device)(*args)
    launches_first = dict(K.LAUNCHES)
    for _ in range(2):
        got = cog(*args)
    info = cog.plan_info()
    interp(*args)
    res["npb compile-of-grad"] = {
        "matches": [(m.computation, m.format)
                    for m in cog.last_report.matches],
        "selections": [n for _, n in cog.last_selections],
        "launches_first_call": launches_first, **grad_errors(got, want),
        "first_call_s": first_s[0], "baked": info["baked"],
        "plan_hits": info["plan_hits"],
        "plans": [p.get("cuda_graph") for p in info["plans"]],
        "plan_ms": ms(lambda: cog(*args), reps),
        "bake=False ms": ms(lambda: interp(*args), reps),
        "uncompiled ms": ms(lambda: grad(*args), reps)}
    del cog, interp, want, got
    release(device)

    ah = mats["hpcg"][0]
    h = torch.randn((ah.cols, GNN_WIDTH), generator=gen).to(device)
    bias = torch.randn(GNN_WIDTH, generator=gen).to(device)
    gargs = (ah.val, ah.col_ind, ah.row_ptr, h, bias)
    gnn = lilac.compile(gnn_step, mode="host", device=device)
    B.reset_launches()
    before = memory_mark(device)
    got = grads_of(gnn, gargs, (0, 3, 4))
    launches = dict(B.LAUNCHES)
    peak, _ = memory_read(device, before)
    step_ms = ms(lambda: grads_of(gnn, gargs, (0, 3, 4)), 2)
    (m,) = gnn.last_report.matches
    sel = [n for _, n in gnn.last_selections]
    del gnn
    release(device)
    before = memory_mark(device)
    want = grads_of(gnn_step, gargs, (0, 3, 4))
    naive_peak, _ = memory_read(device, before)
    res["gnn step gradient"] = {
        "match": (m.computation, m.format, m.epilogue), "selections": sel,
        "launches": launches, **grad_errors(got, want),
        "fwd+bwd ms": step_ms, "peak_bytes": peak,
        "naive fwd+bwd ms": ms(lambda: grads_of(gnn_step, gargs,
                                                     (0, 3, 4)), 2),
        "naive_peak_bytes": naive_peak}
    del got, want, h
    release(device)

    ell = ell_from_csr(a, lane=128)
    vec = torch.randn(a.cols, generator=gen).to(device)
    lbias = torch.randn(a.rows, generator=gen).to(device)
    largs = (ell.val, ell.col, vec, lbias)
    layer = lilac.compile(ell_layer, device=device)
    K.reset_launches()
    got = grads_of(layer, largs, (0, 2, 3))
    launches = dict(K.LAUNCHES)
    op = torch.ops.lilac_torch.spmv_ell.default
    grad_in = [t.detach().requires_grad_() if t.is_floating_point() else t
               for t in largs]
    epilogues = {
        "grad": [n.args[6] for n in layer.graph_for(*grad_in).graph.nodes
                 if n.target is op],
        "plain": [n.args[6] for n in layer.graph_for(*largs).graph.nodes
                  if n.target is op]}
    want = grads_of(ell_layer, largs, (0, 2, 3))
    res["ell layer gradient (trace mode)"] = {
        "selections": [n for _, n in layer.last_selections],
        "launches": launches, "epilogues": epilogues,
        **grad_errors(got, want),
        "fwd+bwd ms": ms(lambda: grads_of(layer, largs, (0, 2, 3)),
                              reps),
        "naive fwd+bwd ms": ms(lambda: grads_of(ell_layer, largs,
                                                     (0, 2, 3)), reps)}
    return res


def check_grad_path(res) -> None:
    for key in ("npb grad-of-compile default", "npb grad-of-compile cuda.ell",
                "npb compile-of-grad", "gnn step gradient",
                "ell layer gradient (trace mode)"):
        require(res[key]["within_tol"],
                f"{key}: gradients within {GRAD_ATOL} * max|ref| + "
                f"{GRAD_RTOL} * |ref| of the uncompiled autograd's, got "
                f"max |err| {res[key]['max_abs_err']} at scales "
                f"{res[key]['scale']}")
    r = res["npb grad-of-compile cuda.ell"]
    require(r["selections"] == ["cuda.ell"]
            and r["launches"]["spmv_ell_staged"] == 1,
            f"npb grad-of-compile: cuda.ell and one K1 staged launch, got "
            f"{r['selections']} and {r['launches']}")
    r = res["npb compile-of-grad"]
    require(r["matches"] == [("spmv_csr", "CSR"), ("spmv_csr", "COO")],
            f"npb compile-of-grad: the forward SpMV and the SpMVᵀ, got "
            f"{r['matches']}")
    require(r["selections"] == ["cuda.ell", "cuda.ell"]
            and r["launches_first_call"]["spmv_ell_staged"] == 2,
            f"npb compile-of-grad: both on cuda.ell, two K1 staged launches "
            f"a call, got {r['selections']} and {r['launches_first_call']}")
    require(r["baked"] == 1 and r["plan_hits"] == 2,
            f"npb compile-of-grad: the third call from a baked plan, got "
            f"baked {r['baked']}, plan hits {r['plan_hits']}")
    r = res["gnn step gradient"]
    require(r["match"] == ("spmm_csr", "CSR", "relu")
            and r["selections"] == ["cuda.bcsr"]
            and r["launches"]["bsr_spmm_wide"] == 1,
            f"gnn step gradient: spmm_csr/CSR +relu on cuda.bcsr, one K3 "
            f"wide launch, got {r['match']}, {r['selections']}, "
            f"{r['launches']}")
    r = res["ell layer gradient (trace mode)"]
    require(r["selections"] == ["cuda.ell"]
            and r["launches"]["spmv_ell"] == 1,
            f"ell layer gradient: cuda.ell, one K1 direct launch, got "
            f"{r['selections']} and {r['launches']}")
    require(r["epilogues"] == {"grad": [None], "plain": ["relu"]},
            f"ell layer gradient: the epilogue unfused under grad and fused "
            f"without, got {r['epilogues']}")


# ---------------------------------------------------------------------------
# Training: OLMoE-1B-7B at full width, its depth cut to TRAIN_LAYERS
# ---------------------------------------------------------------------------

# of OLMoE-1B-7B's 16: one, for the script's time limit (at 2 layers the
# whole script took 1,340.5 s on a slow host, an NVIDIA H100 80GB HBM3 at
# 700 W)
TRAIN_LAYERS = 1
TRAIN_BATCH, TRAIN_SEQ = 2, 1024
TRAIN_STEPS, TRAIN_CKPT_EVERY = 4, 2
# the loop's step runs compiled (train.loop.compile_step); the same step
# uncompiled runs EAGER_TRAIN_STEPS steps beside it
TRAIN_BACKEND = "inductor"
EAGER_TRAIN_STEPS = 2
NAIVE_TRAIN_STEPS = 3
# steps of the lilac model with the MoE's plans dropped and baking off
# (the route before plans under transforms), for its ms and its numbers
UNPLANNED_TRAIN_STEPS = 2
# the lilac step's first loss and gradients against the naive step's from
# the same parameters and batch: bf16 parameters and activations, the
# MoE layer's tolerance (MOE_RTOL) for every gradient leaf
TRAIN_LOSS_RTOL = 1e-2
TRAIN_GRAD_RTOL = 2e-2


def expert_loads(idx, experts: int):
    """(sequences, experts) token-expert pairs an expert, from the
    router's (B, S, K) choices."""
    import torch

    flat = idx.reshape(idx.shape[0], -1).long()
    return torch.zeros((flat.shape[0], experts), dtype=torch.long,
                       device=idx.device).scatter_add_(
                           1, flat, torch.ones_like(flat))


def routing_diagnosis(cfg, params, batch) -> dict:
    """Why the routes collapse at init, layer by layer on ``batch``: the
    RMS of the residual stream entering the layer, of the attention
    block's output and of the MoE block's; the mean cosine of each
    position's router input with its sequence's mean input; the spread of
    the router's logits across positions (their std over positions,
    averaged over experts) against across experts; the distinct top-1
    experts and the largest expert load.  Also returns each layer's
    router input, for ``moe_layer_timing``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.models.spec import tree_map

    def rms(t):
        return float(t.float().pow(2).mean().sqrt())

    out, inputs = [], []
    with torch.no_grad():
        x = params["embed"][batch["tokens"].long()]
        B, S = x.shape[:2]
        pos = torch.arange(S, dtype=torch.int32, device=x.device)[None] \
            .expand(B, S)
        for j in range(cfg.n_layers):
            bp = tree_map(lambda a: a[j], params["blocks"])["b0"]
            attn = L.attention_block(bp["attn"], T._norm_apply(
                cfg, bp["ln1"], x), positions=pos, kv_chunk=cfg.kv_chunk)
            h = T._norm_apply(cfg, bp["ln2"], x + attn)
            logits = torch.einsum("bsd,de->bse", h.float(),
                                  bp["moe"]["router"])
            _, idx = torch.topk(logits, cfg.moe_topk, dim=-1)
            moe, _ = L.moe_block(bp["moe"], h, topk=cfg.moe_topk,
                                 impl="naive")
            out.append({
                "residual_rms": rms(x), "attn_rms": rms(attn),
                "moe_rms": rms(moe),
                "router_input_cos_to_mean": float(F.cosine_similarity(
                    h.float(), h.float().mean(1, keepdim=True), dim=-1)
                    .mean()),
                "logit_std_across_positions": float(logits.std(1).mean()),
                "logit_std_across_experts": float(logits.std(2).mean()),
                "distinct_top1": int(idx[..., 0].unique().numel()),
                "max_load": int(expert_loads(idx, cfg.moe_experts).max())})
            inputs.append(h)
            x = x + attn + moe
    return {"layers": out}, inputs


def moe_layer_timing(cfg, p, hidden: dict, reps: int = 3) -> dict:
    """Layer 0's MoE block forward + backward (x and its four parameters),
    ``impl`` lilac against naive, device ms by CUDA events, on each of
    ``hidden``'s router inputs (name -> (B, S, D)), with the largest
    expert load of the routes it gives."""
    import torch
    from repro_torch.models import layers as L

    res = {}
    for name, h in hidden.items():
        with torch.no_grad():
            _, idx, _ = L.moe_router(p, h, cfg.moe_topk)
        row = {"max_load": int(expert_loads(idx, cfg.moe_experts).max()),
               "mean_load": h.shape[1] * cfg.moe_topk / cfg.moe_experts}
        for impl in ("lilac", "naive"):
            def fwd_bwd(impl=impl):
                x = h.detach().requires_grad_()
                pp = {k: v.detach().requires_grad_() for k, v in p.items()}
                out, aux = L.moe_block(pp, x, topk=cfg.moe_topk, impl=impl)
                (out.float().pow(2).mean() + aux).backward()
            row[f"{impl} fwd+bwd ms"] = cuda_ms(fwd_bwd, reps)
        res[name] = row
    return res


def train_path(seed: int, device, work: str, cfg=None,
               layers: int = TRAIN_LAYERS, batch: int = TRAIN_BATCH,
               seq: int = TRAIN_SEQ, steps: int = TRAIN_STEPS,
               backend: str = TRAIN_BACKEND) -> dict:
    """OLMoE-1B-7B (full width, ``layers`` deep, moe_impl="lilac", no
    remat) trained through make_train_step / train_loop on SyntheticLM:
    the first step's loss and gradients against moe_impl="naive" from the
    same parameters and batch, the token-expert pairs past the backward's
    capacity, ``steps`` steps of the loop's compiled step (``backend``)
    with a checkpoint every TRAIN_CKPT_EVERY (deterministic algorithms;
    each step's host wall time to its loss, the K4 launches of inductor's
    program, the graph breaks, the peak memory), a restart from the first
    checkpoint run to the end on the same compiled entry,
    EAGER_TRAIN_STEPS steps of the same step uncompiled, UNPLANNED_TRAIN_STEPS
    of it with the MoE's plans dropped and baking off (the unplanned
    route) and NAIVE_TRAIN_STEPS steps of the naive model for timing.
    Each uncompiled step: CUDA-event ms, loss, grad norm, peak memory and
    the compiled MoE's plan hits."""
    import shutil as _shutil

    import torch
    from repro_torch.configs.olmoe_1b_7b import CONFIG as OLMOE
    from repro_torch.core.harness import REGISTRY
    from repro_torch.kernels.moe_gmm import kernel as G
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.train import optim as O
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.loop import (LoopConfig, _deterministic,
                                        compile_step, train_loop)
    from repro_torch.train.train_step import make_train_step, value_and_grad
    from torch._subclasses.fake_tensor import is_fake

    cfg = (cfg or OLMOE).replace(n_layers=layers, moe_impl="lilac",
                                 remat=False)
    model = build_model(cfg)
    naive_model = build_model(cfg.replace(moe_impl="naive"))
    params = model.init(torch.Generator(device=device).manual_seed(seed + 11),
                        device)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                       seed=seed)
    b0 = {k: torch.as_tensor(v, device=device)
          for k, v in data.batch_at(0).items()}
    res = {"config": {"name": cfg.name, "layers": layers,
                      "d_model": cfg.d_model, "experts": cfg.moe_experts,
                      "topk": cfg.moe_topk, "vocab": cfg.vocab,
                      "batch": batch, "seq": seq,
                      "params": model.param_count(),
                      "active_params": model.active_param_count()}}

    # the oracle: the first step's loss and gradients, lilac against naive;
    # the routes recorded on the way, for the capacity count
    routes = []
    router = L.moe_router

    def recording_router(p, x, topk):
        gate, idx, aux = router(p, x, topk)
        if not is_fake(idx):    # not the gradient check's fake trace
            routes.append(idx.detach())
        return gate, idx, aux

    L.moe_router = recording_router
    try:
        G.reset_launches()
        sync(device)
        t0 = time.perf_counter()
        loss_l, g_l = value_and_grad(model.loss_fn)(params, b0)
        sync(device)
        res["oracle_lilac_first_s"] = time.perf_counter() - t0
        res["oracle_launches"] = dict(G.LAUNCHES)
    finally:
        L.moe_router = router
    fast = L._lilac_moe_2d(device.type)
    res["moe_selections"] = [n for _, n in fast.last_selections]
    loss_n, g_n = value_and_grad(naive_model.loss_fn)(params, b0)
    from repro_torch.models.spec import leaves

    flat_n = dict(leaves(g_n))
    rel = {k: rel_l2(g, flat_n[k]) for k, g in leaves(g_l)}
    res.update(loss_lilac=float(loss_l), loss_naive=float(loss_n),
               loss_rel=abs(float(loss_l) - float(loss_n))
               / abs(float(loss_n)),
               grad_rel_l2_max=max(rel.values()),
               grad_rel_l2_worst=max(rel, key=rel.get),
               grads_finite=all(bool(torch.isfinite(g).all())
                                for _, g in leaves(g_l)))
    del g_l, g_n, flat_n
    T, K, E = seq, cfg.moe_topk, cfg.moe_experts
    cap = max(8, min(-(-T * K * 2 // E), T * K))  # _moe_capacity's rule
    loads = torch.cat([expert_loads(r, E) for r in routes])
    res.update(capacity=cap, mean_load=T * K / E,
               max_load=int(loads.max()),
               pairs_past_capacity=int((loads - cap).clamp_min(0).sum()))
    res["routing_at_init"], inputs = routing_diagnosis(cfg, params, b0)
    if device.type == "cuda":
        # the MoE layer at the routes of the model at init (collapsed) and
        # at those of unit-normal router inputs (spread), same shapes
        gen = torch.Generator(device=device).manual_seed(seed + 13)
        spread = torch.randn(inputs[0].shape, generator=gen, device=device
                             ).to(inputs[0].dtype)
        p0 = {k: v[0] for k, v in params["blocks"]["b0"]["moe"].items()}
        res["moe_layer_timing"] = moe_layer_timing(
            cfg, p0, {"model at init": inputs[0], "unit normal": spread})
        del spread, p0
    del inputs
    release(device)

    # the loop through its compiled step (inductor; one graph: forward,
    # backward, AdamW), with a checkpoint every TRAIN_CKPT_EVERY steps,
    # then the restart from the first checkpoint on the same compiled entry
    opt = O.AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=100)
    ckdir = Path(work) / "ckpt"
    log: list = []
    fast = L._lilac_moe_2d(device.type)

    def timed_step(fn):
        """``fn`` timed by CUDA events (a host clock on the CPU)."""
        def run(p, s, b):
            hits = fast.plan_info()["plan_hits"]
            before = memory_mark(device)
            if device.type == "cuda":
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
            t0 = time.perf_counter()
            out = fn(p, s, b)
            if device.type == "cuda":
                e1.record()
                torch.cuda.synchronize()
                ms = e0.elapsed_time(e1)
            else:
                ms = 1e3 * (time.perf_counter() - t0)
            peak, _ = memory_read(device, before)
            log.append({"ms": ms, "loss": float(out[2]["loss"]),
                        "grad_norm": float(out[2]["grad_norm"]),
                        "peak_bytes": peak or 0,
                        "plan_hits": fast.plan_info()["plan_hits"] - hits})
            return out
        return run

    lc = LoopConfig(steps=steps, ckpt_every=TRAIN_CKPT_EVERY, log_every=1,
                    ckpt_dir=str(ckdir), deterministic=True)
    heartbeat: list = []
    entry = compile_step(make_train_step(model, opt), backend)
    G.reset_launches()
    before = memory_mark(device)
    r1 = train_loop(model, opt, lc, data.batch_at, params=params,
                    device=device, step_fn=entry, emit=heartbeat.append)
    peak, _ = memory_read(device, before)
    res.update(loop_launches=dict(G.LAUNCHES), history=r1["history"],
               step_seconds=r1["step_seconds"], compiled=r1["compiled"],
               compiled_peak_bytes=peak or 0,
               disk_free_bytes=_shutil.disk_usage(work).free,
               checkpoints=sorted(int(d.name[5:]) for d in ckdir.iterdir()
                                  if d.is_dir() and not d.name.endswith(
                                      ".tmp")))
    del r1
    release(device)
    for s in res["checkpoints"]:
        if s > TRAIN_CKPT_EVERY:
            _shutil.rmtree(ckdir / f"step_{s}")
    t0 = time.perf_counter()
    r2 = train_loop(model, opt, lc, data.batch_at, params=params,
                    device=device, step_fn=entry, emit=heartbeat.append)
    res.update(restart_start_step=r2["start_step"],
               restart_history=r2["history"],
               restart_step_seconds=r2["step_seconds"],
               restart_compiled=r2["compiled"],
               restart_seconds=time.perf_counter() - t0)
    del r2
    _shutil.rmtree(ckdir, ignore_errors=True)
    release(device)

    # the same step uncompiled (backend=None), timed: its ms, loss, memory
    # and the MoE's plan hits, with the routes recorded on the way
    step = timed_step(make_train_step(model, opt))
    routes.clear()
    L.moe_router = recording_router
    try:
        r0 = train_loop(model, opt, LoopConfig(steps=EAGER_TRAIN_STEPS,
                                               log_every=1,
                                               deterministic=True),
                        data.batch_at, params=params, device=device,
                        step_fn=step, backend=None, emit=heartbeat.append)
    finally:
        L.moe_router = router
    # the largest expert load of each step's layers (the router runs once
    # a layer in a step's forward)
    res["step_max_loads"] = [
        [int(expert_loads(r, E).max()) for r in routes[i:i + layers]]
        for i in range(0, len(routes), layers)]
    routes.clear()
    res.update(steps=list(log), eager_history=r0["history"],
               eager_step_seconds=r0["step_seconds"])
    res["moe_plans"] = [{k: q[k] for k in ("transform", "runs",
                                           "eager_reason", "hits")}
                        for q in fast.plan_info()["plans"]]
    del r0
    release(device)

    # the naive step, for its time
    log.clear()
    naive_step = timed_step(make_train_step(naive_model, opt))
    p, s = params, O.adamw_init(opt, params)
    for i in range(NAIVE_TRAIN_STEPS):
        batch_i = {k: torch.as_tensor(v, device=device)
                   for k, v in data.batch_at(i).items()}
        p, s, _ = naive_step(p, s, batch_i)
    res["naive_steps"] = list(log)
    if device.type == "cuda":
        res["naive_profile"] = step_breakdown(
            lambda: naive_step(p, s, b0), device)
    del p, s
    release(device)
    if device.type == "cuda":
        st = O.adamw_init(opt, params)
        with _deterministic(True):      # the state the loop compiled under
            res["compiled_profile"] = step_breakdown(
                lambda: entry(params, st, b0), device)
        lilac_step = make_train_step(model, opt)
        res["lilac_profile"] = step_breakdown(
            lambda: lilac_step(params, st, b0), device)
        del st
        release(device)

    # the unplanned route (after the profiles, which time planned steps):
    # baking off, so each MoE call runs its rewritten graph under vmap
    log.clear()
    fast.invalidate_plans()
    fast.bake_enabled = False
    try:
        p, s = params, O.adamw_init(opt, params)
        was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)       # as the loop ran
        try:
            for i in range(UNPLANNED_TRAIN_STEPS):
                batch_i = {k: torch.as_tensor(v, device=device)
                           for k, v in data.batch_at(i).items()}
                p, s, _ = step(p, s, batch_i)
        finally:
            torch.use_deterministic_algorithms(was)
        del p, s
    finally:
        fast.bake_enabled = True
    res["unplanned_steps"] = list(log)
    res["heartbeat"] = heartbeat
    res["tuner"] = REGISTRY.autotuner.stats.as_dict()
    return res


def kernel_kind(name: str) -> str:
    """A coarse class of a CUDA kernel by its name."""
    n = name.lower()
    for kind, keys in (("K4 (gmm)", ("gmm_tc", "gmm_simt")),
                       ("GEMM (cuBLAS)", ("gemm", "cutlass", "xmma", "sm90_",
                                          "cublas", "nvjet")),
                       ("gather/scatter/sort", ("index", "scatter", "gather",
                                                "sort", "radix", "put_")),
                       ("reduction", ("reduce", "softmax", "logsumexp")),
                       ("elementwise", ("elementwise", "vectorized", "unrolled",
                                        "copy", "fill", "cat"))):
        if any(k in n for k in keys):
            return kind
    return "other"


def step_breakdown(fn, device, top: int = 8):
    """One call of ``fn()`` under torch.profiler: device time by kernel
    class and the ``top`` kernels, the call's wall ms and the device's
    idle share of it (1 - kernel time / wall time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync(device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
    with prof:
        t0 = time.perf_counter()
        fn()
        sync(device)
        wall = 1e3 * (time.perf_counter() - t0)
    kernels = [(e.key, e.device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.device_time_total]
    kinds: dict = {}
    for name, ms, _ in kernels:
        kinds[kernel_kind(name)] = kinds.get(kernel_kind(name), 0.0) + ms
    busy = sum(ms for _, ms, _ in kernels)
    return {"wall_ms": wall, "kernel_ms": busy,
            "idle_share": max(0.0, 1 - busy / wall) if wall else None,
            "by_kind_ms": dict(sorted(kinds.items(), key=lambda kv: -kv[1])),
            "top": [(n[:80], round(ms, 3), c) for n, ms, c in
                    sorted(kernels, key=lambda k: -k[1])[:top]]}


def _median_ms(seconds) -> float:
    """The median of a list of host seconds, in ms."""
    v = sorted(seconds)
    return 1e3 * v[len(v) // 2] if v else float("nan")


def print_train_path(tr) -> None:
    c = tr["config"]
    print(f"training {c['name']} (d_model {c['d_model']}, {c['experts']} "
          f"experts top-{c['topk']}, vocab {c['vocab']}) cut to "
          f"{c['layers']} layers: {c['params']} params ({c['active_params']} "
          f"active), batch {c['batch']} x seq {c['seq']}, moe_impl=lilac via "
          f"{tr['moe_selections']}")
    print(f"training oracle, first step: loss {tr['loss_lilac']:.6f} "
          f"(naive {tr['loss_naive']:.6f}, rel {tr['loss_rel']:.3g}, tol "
          f"{TRAIN_LOSS_RTOL}); worst gradient leaf relative L2 "
          f"{tr['grad_rel_l2_max']:.3g} at {tr['grad_rel_l2_worst']} (tol "
          f"{TRAIN_GRAD_RTOL}); token-expert pairs past capacity "
          f"{tr['pairs_past_capacity']} (capacity {tr['capacity']}, mean "
          f"load {tr['mean_load']:g}, max load {tr['max_load']}); first "
          f"lilac forward+backward {tr['oracle_lilac_first_s']:.2f}s; K4 "
          f"launches {tr['oracle_launches']}")
    for j, lr in enumerate(tr["routing_at_init"]["layers"]):
        print(f"training routing at init, layer {j}: " + ", ".join(
            f"{k} {v:.4g}" for k, v in lr.items()))
    for name, row in tr.get("moe_layer_timing", {}).items():
        print(f"training MoE layer 0 fwd+bwd at the routes of {name}: "
              f"max load {row['max_load']} (mean {row['mean_load']:g}); "
              f"lilac {row['lilac fwd+bwd ms']}, naive "
              f"{row['naive fwd+bwd ms']} (device ms, host ms)")
    cs = tr["compiled"]
    first, eager = tr["history"][0], tr["eager_history"][0]
    print(f"training compiled step ({cs['backend']}, fullgraph "
          f"{cs['fullgraph']}): {cs['compiles']} graph, {cs['graph_breaks']} "
          f"graph breaks; first step (its compile) {cs['compile_seconds']:.1f}s; "
          f"steady {_median_ms(tr['step_seconds'][1:]):.2f} ms a step "
          f"(host wall to the loss, median of {len(tr['step_seconds']) - 1}) "
          f"against the uncompiled step's "
          f"{_median_ms(tr['eager_step_seconds'][1:]):.2f} ms; K4 launches "
          f"{tr['loop_launches']['gmm'] / len(tr['history']):g} a step from "
          f"inductor's program ({tr['loop_launches']} over "
          f"{len(tr['history'])}); first loss {first:.6f} against the "
          f"uncompiled step's {eager:.6f} (rel "
          f"{abs(first - eager) / abs(eager):.3g}) and naive's "
          f"{tr['loss_naive']:.6f} (rel "
          f"{abs(first - tr['loss_naive']) / abs(tr['loss_naive']):.3g}, "
          f"tol {TRAIN_LOSS_RTOL}); peak {tr['compiled_peak_bytes'] / 2**30:.2f}"
          f" GiB over the compiled loop against "
          f"{max(st['peak_bytes'] for st in tr['steps']) / 2**30:.2f} GiB "
          f"an uncompiled step (no buffer donation in torch)")
    print(f"training compiled losses {tr['history']}, step seconds "
          f"{[round(t, 4) for t in tr['step_seconds']]}; restart from step "
          f"{tr['restart_start_step']} on the same graph "
          f"({tr['restart_compiled']['compiles']} compile in all) in "
          f"{tr['restart_seconds']:.1f}s, losses {tr['restart_history']}; "
          f"checkpoints {tr['checkpoints']}")
    print(f"training: the largest expert load of each uncompiled step's "
          f"layers {tr['step_max_loads']}")
    for i, st in enumerate(tr["steps"]):
        print(f"training uncompiled step {i}: {train_line(st)}")
    for i, st in enumerate(tr["unplanned_steps"]):
        print(f"training unplanned step {i} (the MoE's plans dropped, "
              f"baking off): {train_line(st)}")
    print(f"training: the uncompiled step's MoE plan hits by step "
          f"{[st['plan_hits'] for st in tr['steps']]}; plans "
          f"{tr['moe_plans']}")
    for i, st in enumerate(tr["naive_steps"]):
        print(f"training naive step {i}: {train_line(st)}")
    print(f"training: the process took {tr.get('seconds', 0.0):.1f}s")
    for name in ("compiled_profile", "lilac_profile", "naive_profile"):
        pr = tr.get(name)
        if pr is None:
            continue
        print(f"training {name.split('_')[0]} step profiled: "
              f"{pr['wall_ms']:.1f} ms wall, {pr['kernel_ms']:.1f} ms of "
              f"kernels (idle share {pr['idle_share']:.3f}); by kind "
              f"{ {k: round(v, 2) for k, v in pr['by_kind_ms'].items()} }; "
              f"top {pr['top']}")


def check_train_path(res, steps: int = TRAIN_STEPS,
                     layers: int = TRAIN_LAYERS,
                     batch: int = TRAIN_BATCH) -> None:
    require(res["moe_selections"] == ["cuda.gmm"],
            f"training: the inner MoE on cuda.gmm, got "
            f"{res['moe_selections']}")
    # the block vmaps over the batch's sequences: one moe_ffn a layer
    per_step = 3 * layers
    require(res["oracle_launches"]["gmm"] == per_step
            and res["loop_launches"]["gmm"] == per_step * steps,
            f"training: {per_step} K4 bf16 launches a step (3 x {layers} "
            f"layers, the {batch} sequences vmapped), the loop's from its "
            f"compiled program, got {res['oracle_launches']} for one step "
            f"and {res['loop_launches']} for {steps}")
    c = res["compiled"]
    require(c["fullgraph"] and c["compiles"] == 1 and c["graph_breaks"] == 0
            and res["restart_compiled"]["compiles"] == 1,
            f"training: the step compiled once, as one graph with no break, "
            f"the restart on the same graph, got {c} and "
            f"{res['restart_compiled']}")
    require(res["loss_rel"] <= TRAIN_LOSS_RTOL,
            f"training: the first loss within {TRAIN_LOSS_RTOL} of the "
            f"naive step's, got {res['loss_lilac']} against "
            f"{res['loss_naive']}")
    first, eager = res["history"][0], res["eager_history"][0]
    require(abs(first - eager) <= TRAIN_LOSS_RTOL * abs(eager)
            and abs(first - res["loss_naive"])
            <= TRAIN_LOSS_RTOL * abs(res["loss_naive"]),
            f"training: the compiled step's first loss within "
            f"{TRAIN_LOSS_RTOL} of the uncompiled step's and the naive "
            f"step's, got {first} against {eager} and {res['loss_naive']}")
    require(res["grads_finite"] and res["grad_rel_l2_max"] <= TRAIN_GRAD_RTOL,
            f"training: every gradient leaf within relative L2 "
            f"{TRAIN_GRAD_RTOL} of the naive step's, got "
            f"{res['grad_rel_l2_max']:.3g} at {res['grad_rel_l2_worst']}")
    require(len(res["history"]) == steps
            and all(abs(v) < float("inf") for v in res["history"]),
            f"training: {steps} finite losses, got {res['history']}")
    require(res["restart_start_step"] == TRAIN_CKPT_EVERY
            and res["restart_history"] == res["history"][TRAIN_CKPT_EVERY:],
            f"training: the restart from step {TRAIN_CKPT_EVERY} repeats the "
            f"uninterrupted losses bit for bit, got "
            f"{res['restart_history']} against {res['history']}")
    hits = [st["plan_hits"] for st in res["steps"]]
    require(len(hits) == EAGER_TRAIN_STEPS
            and all(h == layers for h in hits[1:])
            and any(q["transform"] and q["transform"]["grad"]
                    and q["transform"]["vmap"] and q["runs"] == "eager"
                    for q in res["moe_plans"]),
            f"training: the uncompiled step's MoE calls from its second "
            f"step a hit each on a gradient-carrying batched plan run "
            f"eagerly ({layers} a step), got {hits} hits by step, plans "
            f"{res['moe_plans']}")
    un = res["unplanned_steps"]
    require(len(un) == UNPLANNED_TRAIN_STEPS
            and all(st["plan_hits"] == 0 for st in un)
            and all(abs(u["loss"] - st["loss"]) <= TRAIN_LOSS_RTOL
                    * abs(st["loss"])
                    and abs(u["grad_norm"] - st["grad_norm"])
                    <= TRAIN_GRAD_RTOL * abs(st["grad_norm"])
                    for u, st in zip(un, res["steps"])),
            f"training: the planned steps' loss and grad norm within "
            f"{TRAIN_LOSS_RTOL} and {TRAIN_GRAD_RTOL} of the unplanned "
            f"route's, got {[(u['loss'], u['grad_norm']) for u in un]} "
            f"against {[(st['loss'], st['grad_norm']) for st in res['steps']]}")


# ---------------------------------------------------------------------------
# Distributed training: OLMoE-1B-7B on a (data 2, model 2) mesh, 4 ranks
# ---------------------------------------------------------------------------

DIST_MESH = (2, 2)             # (data, model)
DIST_STEPS = 1
# the mesh step compiled, one step (its compile and its run).  Its
# ~35 graphs between the host-staged collectives compile with aot_eager:
# at inductor's 12-31 s a small graph on this card (the serving phase's)
# they would take minutes a rank
DIST_BACKEND = "aot_eager"
DIST_COMPILED_STEPS = 1
DIST_RANKS = DIST_MESH[0] * DIST_MESH[1]


def _replicas(pspec, names) -> int:
    """How many ranks of the current mesh hold the same block of a leaf
    at ``pspec``."""
    from repro_torch.launch import collectives as C
    from repro_torch.models.spec import pspec_axes

    used = {a for e in pspec for a in pspec_axes(e)}
    return C.axis_size(tuple(a for a in names if a not in used))


def mesh_rel_l2(got, want, specs, names) -> dict:
    """Each leaf's relative L2 error of the whole (gathered) tensor, from
    the ranks' blocks: every block's squared error and squared norm over
    its replica count, summed over the mesh."""
    import torch
    from repro_torch.launch import collectives as C
    from repro_torch.models.spec import leaves

    want, specs = dict(leaves(want)), dict(leaves(specs))
    keys, sums = [], []
    for k, g in leaves(got):
        w = C.local_of(want[k], specs[k]).float()
        reps = _replicas(specs[k], names)
        keys.append(k)
        sums.append(torch.stack([((g.float() - w) ** 2).sum() / reps,
                                 (w ** 2).sum() / reps]))
    tot = C.psum(torch.stack(sums), tuple(names))
    return {k: float(torch.sqrt(n / d.clamp_min(1e-30)))
            for k, (n, d) in zip(keys, tot)}


def dist_path(seed: int, device, work: str, cfg=None,
              layers: int = TRAIN_LAYERS, batch: int = TRAIN_BATCH,
              seq: int = TRAIN_SEQ, steps: int = DIST_STEPS,
              mesh_shape=DIST_MESH, reps: int = 5,
              backend: str = DIST_BACKEND) -> dict:
    """One rank's part of the distributed phase (the process group up):
    OLMoE-1B-7B (full width, ``layers`` deep, moe_impl="lilac", no remat,
    the training phase's parameters and batch) on a (data, model) mesh
    with sequence parallelism.  The rank's one-device step on the same
    parameters and batch is the oracle of the mesh's first step (loss,
    every gradient leaf over the mesh); each MoE layer's mesh output is
    held against the naive dispatch on the same input; one K4 launch over
    the rank's experts against its plain version; ``steps`` steps of
    make_train_step on the mesh (ms, loss, grad norm, K4 launches, peak);
    DIST_COMPILED_STEPS of the same step compiled with ``backend`` (its
    graphs and graph breaks counted); and the initial parameters saved
    from the mesh and restored onto a (ranks, 1) mesh and onto one device,
    bit for bit."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.olmoe_1b_7b import CONFIG as OLMOE
    from repro_torch.kernels.moe_gmm import kernel as G
    from repro_torch.kernels.moe_gmm import ref as GR
    from repro_torch.kernels.moe_gmm.ops import _route
    from repro_torch.launch import collectives as C
    from repro_torch.launch.mesh import make_host_mesh, mesh_rules
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.models.spec import leaves
    from repro_torch.train import optim as O
    from repro_torch.train import train_step as TS
    from repro_torch.train.checkpoint import Checkpointer
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.loop import compile_step, shard_params

    t_start = time.perf_counter()
    rank, n = dist.get_rank(), dist.get_world_size()
    D, M = mesh_shape
    cfg = (cfg or OLMOE).replace(n_layers=layers, moe_impl="lilac",
                                 remat=False)

    def on_mesh(d, m):
        return build_model(cfg.replace(
            spmd_constraints=True, mesh_axis_sizes=(("data", d),
                                                    ("model", m))))

    model, mm = build_model(cfg), on_mesh(D, M)
    params = model.init(torch.Generator(device=device).manual_seed(seed + 11),
                        device)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                       seed=seed)
    b0 = {k: torch.as_tensor(v, device=device)
          for k, v in data.batch_at(0).items()}
    res = {"rank": rank, "mesh": list(mesh_shape),
           "config": {"name": cfg.name, "layers": layers,
                      "d_model": cfg.d_model, "experts": cfg.moe_experts,
                      "topk": cfg.moe_topk, "batch": batch, "seq": seq,
                      "params": model.param_count()}}

    routes, oracle_routes, moe_io = [], [], []
    router, block = L.moe_router, L._moe_block_mesh

    def recording_router(p, x, topk, shard_ctx=None):
        out = router(p, x, topk, shard_ctx)
        (oracle_routes if shard_ctx is None else routes).append(
            out[1].detach())
        return out

    # the oracle: the one-device step on this rank
    L.moe_router = recording_router
    try:
        t0 = time.perf_counter()
        loss1, g1 = TS.value_and_grad(model.loss_fn)(params, b0)
        sync(device)
        res["oracle_s"] = time.perf_counter() - t0
    finally:
        L.moe_router = router

    mesh = make_host_mesh(D, M)
    rules = mesh_rules(False)
    names = tuple(mesh.mesh_dim_names)

    def recording_block(p, x, **kw):
        out = block(p, x, **kw)
        moe_io.append((x.detach(), out[0].detach()))
        return out

    with C.use_mesh(mesh):
        psh = TS.param_shardings(mm, mesh, rules)
        specs = TS.storage_pspecs(mm)
        lp0 = shard_params(params, psh)
        bspec = TS.batch_pspec(rules)

        def local_batch(i):
            return {k: C.local_of(torch.as_tensor(v, device=device), bspec)
                    for k, v in data.batch_at(i).items()}

        # the first step's loss and gradients against the oracle
        L.moe_router, L._moe_block_mesh = recording_router, recording_block
        try:
            G.reset_launches()
            C.reset_stats()
            sync(device)
            t0 = time.perf_counter()
            ls, gs = TS.value_and_grad(mm.loss_fn)(lp0, local_batch(0))
            gs = TS._grad_constraint(gs, specs)
            loss = float(C.psum(ls.detach(), names))
            sync(device)
            res["first_step_s"] = time.perf_counter() - t0
            res["first_step_launches"] = dict(G.LAUNCHES)
            res["first_step_collectives"] = {k: dict(v)
                                             for k, v in C.STATS.items()}
        finally:
            L.moe_router, L._moe_block_mesh = router, block
        res["moe_selections"] = [
            nm for _, nm in L._lilac_moe_2d(device.type).last_selections]
        rel = mesh_rel_l2(gs, g1, specs, names)
        res.update(loss_mesh=loss, loss_one_device=float(loss1),
                   loss_rel=abs(loss - float(loss1)) / abs(float(loss1)),
                   grad_rel_l2_max=max(rel.values()),
                   grad_rel_l2_worst=max(rel, key=rel.get),
                   grad_rel_l2_top=sorted(rel.items(),
                                          key=lambda kv: -kv[1])[:4],
                   grads_finite=all(bool(torch.isfinite(g).all())
                                    for _, g in leaves(gs)))
        del gs, g1
        release(device)

        # each MoE layer on the mesh against the naive dispatch on the
        # same input (the layer's input gathered over the sequence)
        E, K = cfg.moe_experts, cfg.moe_topk
        E_loc = -(-E // M)
        m = C.axis_index("model")
        res["moe_layers"], res["routed_rows"] = [], []
        for j, ((x_loc, out_loc), idx) in enumerate(zip(moe_io, routes)):
            p_full = {k: v[j] for k, v in
                      params["blocks"]["b0"]["moe"].items()}
            sp = x_loc.shape[1] < seq       # the rank's sequence chunk
            h = C.all_gather(x_loc, "model", 1) if sp else x_loc
            with torch.no_grad():
                want, _ = L.moe_block(p_full, h, topk=K, impl="naive")
            want = (C.local_chunk(want, "model", 1) if sp else want).float()
            w = 1.0 if sp else 1.0 / M      # model ranks' copies, once
            sums = C.psum(torch.stack([
                w * ((out_loc.float() - want) ** 2).sum(),
                w * (want ** 2).sum()]), names)
            res["moe_layers"].append(float(torch.sqrt(sums[0] / sums[1])))
            local = (idx.long() >= m * E_loc) & (idx.long() < (m + 1) * E_loc)
            res["routed_rows"].append([int(r) for r in
                                       local.reshape(idx.shape[0], -1).sum(1)])
            # tokens whose top-k set differs from the one-device step's
            d = C.axis_index("data")
            one = oracle_routes[j][d * idx.shape[0]:(d + 1) * idx.shape[0]]
            res.setdefault("route_flips", []).append(int(
                (idx.sort(-1).values != one.sort(-1).values).any(-1).sum()))
            if j == 0:
                h0, idx0, w0 = h[0], idx[0], p_full["wg"][
                    m * E_loc:(m + 1) * E_loc]
        tm = 128
        res["tp"] = int(-(-seq * K // tm) * tm + (E_loc - 1) * tm)
        del moe_io, routes
        release(device)

        # the mesh's training steps
        opt = O.AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=100)
        step = TS.make_train_step(mm, opt)
        lp, st = lp0, O.adamw_init(opt, lp0)
        res["steps"] = []
        for i in range(steps):
            lb = local_batch(i)
            G.reset_launches()
            C.reset_stats()
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            sync(device)
            t0 = time.perf_counter()
            lp, st, met = step(lp, st, lb)
            sync(device)
            ms = 1e3 * (time.perf_counter() - t0)
            res["steps"].append({
                "ms": ms, "loss": float(met["loss"]),
                "grad_norm": float(met["grad_norm"]),
                "launches": dict(G.LAUNCHES),
                "collective_bytes": sum(v["bytes"]
                                        for v in C.STATS.values()),
                "peak_bytes": (torch.cuda.max_memory_allocated()
                               if device.type == "cuda" else 0)})
        del lp, st
        release(device)

        # the same mesh step compiled (train.loop.compile_step): the
        # host-staged collectives and torch.autograd.grad are graph breaks
        centry = compile_step(TS.make_train_step(mm, opt), backend)
        lp, st = lp0, O.adamw_init(opt, lp0)
        res["compiled_steps"] = []
        for i in range(DIST_COMPILED_STEPS):
            lb = local_batch(i)
            G.reset_launches()
            sync(device)
            t0 = time.perf_counter()
            lp, st, met = centry(lp, st, lb)
            sync(device)
            res["compiled_steps"].append({
                "ms": 1e3 * (time.perf_counter() - t0),
                "loss": float(met["loss"]),
                "grad_norm": float(met["grad_norm"]),
                "launches": dict(G.LAUNCHES)})
        res["compiled"] = centry.stats()
        del lp, st, centry
        release(device)

        # K4 over this rank's experts against its plain version (the
        # first layer's routes of the rank's first sequence, other ranks'
        # pairs at local expert 0, as the mesh path hands them to K4)
        lidx = idx0.long() - m * E_loc
        mine = (lidx >= 0) & (lidx < E_loc)
        lidx = torch.where(mine, lidx, 0)
        dest, te, tp = _route(lidx, seq, K, E_loc, tm)
        xs = torch.zeros((tp, cfg.d_model), dtype=h0.dtype, device=device)
        xs[dest] = h0.repeat_interleave(K, dim=0)
        routed = int(mine.sum())        # the rank's pairs: the work needed
        nb = routed * cfg.d_model * 2 + nbytes(w0) + routed * cfg.d_ff * 4
        res["gmm"] = {"name": "gmm", "tp": tp, "routed_rows": routed,
                      "library_ms": None, "variants": {
                          "gate_up": variant_numbers(
                              lambda: G.gmm_cuda(xs, w0, te, tm),
                              lambda: GR.gmm_ref(xs, w0, te, tm),
                              "gmm_tc_kernel", device.type == "cuda", reps,
                              nb, 2 * routed * cfg.d_model * cfg.d_ff,
                              xs.dtype, GMM_ATOL, GMM_RTOL,
                              what=f"gmm on rank {rank}'s experts",
                              sum_scale=GR.gmm_ref(xs.abs(), w0.abs(), te,
                                                   tm))}}
        grouped = getattr(torch, "_grouped_mm", None)
        if device.type == "cuda" and grouped is not None:
            counts = torch.bincount(lidx.reshape(-1), minlength=E_loc)
            offs = torch.cumsum((counts + tm - 1) // tm * tm, 0).to(
                torch.int32)
            res["gmm"]["library_ms"] = cuda_ms(
                lambda: grouped(xs, w0, offs=offs), reps)[0]
        del xs, h0, idx0, w0
        release(device)

    # the initial parameters saved from the mesh, restored onto (ranks, 1)
    # and onto one device
    ck = Checkpointer(os.path.join(work, "dist-ckpt"))
    t0 = time.perf_counter()
    with C.use_mesh(mesh):
        ck.save(1, lp0, shardings=psh)
    res["save_s"] = time.perf_counter() - t0
    del lp0
    mesh2 = make_host_mesh(n, 1)
    mm2 = on_mesh(n, 1)
    t0 = time.perf_counter()
    with C.use_mesh(mesh2):
        psh2 = TS.param_shardings(mm2, mesh2, rules)
        want = shard_params(params, psh2)
        got = ck.restore(1, want, psh2)
        res["restore_mesh_equal"] = all(
            torch.equal(a, b) for (_, a), (_, b) in zip(leaves(got),
                                                        leaves(want)))
    del got, want
    res["restore_s"] = time.perf_counter() - t0
    if rank == 0:
        one = ck.restore(1, params)
        res["restore_one_device_equal"] = all(
            torch.equal(a, b) for (_, a), (_, b) in zip(leaves(one),
                                                        leaves(params)))
        del one
    dist.barrier()
    res["peak_bytes"] = (torch.cuda.max_memory_allocated()
                         if device.type == "cuda" else 0)
    res["seconds"] = time.perf_counter() - t_start
    return res


# the recurrent mixers on the same mesh, tensor-parallel over model
MESH_RWKV_LAYERS, MESH_RWKV_SEQ = 2, 512
MESH_JAMBA_LAYERS = 2          # one period of Mamba + MLP, Mamba + MoE
MESH_JAMBA_PROMPT, MESH_JAMBA_STEPS = 64, 8
MESH_F32_RTOL = 1e-4           # the mesh against one device, f32
# the f32 check's decode steps: one f32 decode step gathers the MoE
# layer's 5.6 GB of experts a rank through the host (19.3 s on the card)
MESH_F32_STEPS = 1
# a rank's measured peak against the dry-run's, at most this factor either
# way: the dry-run bakes no plan and stages nothing (its docstring), and
# the measured peaks stood 0.93-1.95 times its own on an NVIDIA H100 80GB
# HBM3 at 700 W (this script's distributed phase, PERF.md)
DRYRUN_PEAK_FACTOR = 2.5


def _mesh_cfgs(D: int, M: int):
    """The phase's recurrent configurations: RWKV-6-1.6B and Jamba-v0.1 at
    full width, depth cut (Jamba to one period of two Mamba layers: its
    MLP layer, then its MoE layer on K4), for one device and the mesh."""
    from repro_torch.configs import get_arch

    rwkv = get_arch("rwkv6-1.6b").replace(n_layers=MESH_RWKV_LAYERS,
                                          remat=False)
    jamba = get_arch("jamba-v0.1-52b").replace(
        n_layers=MESH_JAMBA_LAYERS, attn_layer_period=MESH_JAMBA_LAYERS,
        moe_impl="lilac", moe_decode_impl="lilac")
    on_mesh = dict(spmd_constraints=True,
                   mesh_axis_sizes=(("data", D), ("model", M)))
    return {"rwkv": (rwkv, rwkv.replace(**on_mesh)),
            "jamba": (jamba.replace(moe_impl="naive",
                                    moe_decode_impl="naive_flat"),
                      jamba.replace(**on_mesh))}


def dist_recurrent_path(seed: int, device, mesh_shape=DIST_MESH) -> dict:
    """The recurrent mixers on the mesh, one rank's part: RWKV-6-1.6B's
    training step (its time mix by heads and its channel mix by d_ff over
    the model axis) in bf16 and in f32, each against the one-device step
    (rank 0's, loss and grad norm; the f32 one is held); Jamba-v0.1's
    prefill of one prompt a data rank and MESH_JAMBA_STEPS decode steps
    (Mamba by its inner dim, the MoE layer by experts on K4 through
    moe_impl="lilac"), in bf16 with K4's launches counted and each layer
    held on its own input (a MoE layer against the naive dispatch, a Mamba
    layer's prefill against the one-device block on rank 0), then in f32
    over the prefill and MESH_F32_STEPS decode steps, the logits and every
    new cache leaf against the one-device model (rank 0's, its results
    broadcast).  Each step's peak memory, ms and collectives by mesh
    axis.  Rank 0 keeps the full Jamba parameters on the host, so that
    every rank's peak is its mesh step's."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.moe_gmm import kernel as G
    from repro_torch.launch import collectives as C
    from repro_torch.launch.mesh import make_host_mesh, mesh_rules
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.models import mamba as Mb
    from repro_torch.models.spec import leaves, tree_map
    from repro_torch.train import optim as O
    from repro_torch.train import train_step as TS
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.loop import shard_params

    t_start = time.perf_counter()
    rank = dist.get_rank()
    D, M = mesh_shape
    mesh = make_host_mesh(D, M)
    # the training part's compiled MoE (its plans' CUDA graph pools and
    # the tensors they read in place) and compiled step let go
    L._LILAC_MOE.clear()
    torch._dynamo.reset()
    release(device)

    def progress(what):        # on stderr: where a cut-off run stopped
        if rank == 0:
            print(f"distributed recurrent: {what} at "
                  f"{time.perf_counter() - t_start:.1f}s", file=sys.stderr,
                  flush=True)
    rules = mesh_rules(False)
    names = tuple(mesh.mesh_dim_names)
    cfgs = _mesh_cfgs(D, M)
    cuda = device.type == "cuda"
    res = {"rank": rank, "allocated_at_start": (
        torch.cuda.memory_allocated() if device.type == "cuda" else 0)}

    def fresh_peak():
        release(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        sync(device)

    def peak():
        return torch.cuda.max_memory_allocated() if cuda else 0

    def by_axis():
        return {a: {k: dict(v) for k, v in kinds.items()}
                for a, kinds in C.BY_AXIS.items()}

    # -- RWKV-6-1.6B: one training step on the mesh -------------------------
    cfg, cfg_m = cfgs["rwkv"]
    one, mm = build_model(cfg), build_model(cfg_m)
    params = one.init(torch.Generator(device=device).manual_seed(seed + 13),
                      device)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=MESH_RWKV_SEQ,
                       global_batch=TRAIN_BATCH, seed=seed)
    b0 = {k: torch.as_tensor(v, device=device)
          for k, v in data.batch_at(0).items()}
    opt = O.AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=100)

    def one_device_step(p):
        t0 = time.perf_counter()
        met = TS.make_train_step(one, opt)(p, O.adamw_init(opt, p), b0)[2]
        return {"loss": float(met["loss"]),
                "grad_norm": float(met["grad_norm"]),
                "s": time.perf_counter() - t0}

    # the one-device steps (rank 0's): the f32 oracle, and bf16 beside it
    oracle = [None]
    if rank == 0:
        oracle[0] = {"bf16": one_device_step(params), "f32": one_device_step(
            tree_map(lambda a: a.float(), params))}
    dist.broadcast_object_list(oracle, src=0)
    progress("RWKV-6 one-device steps")
    runs = {}
    with C.use_mesh(mesh):
        psh = TS.param_shardings(mm, mesh, rules)
        lb = {k: C.local_of(v, TS.batch_pspec(rules)) for k, v in b0.items()}
        for name, dtype in (("bf16", None), ("f32", torch.float32)):
            lp = shard_params(params if dtype is None else tree_map(
                lambda a: a.to(dtype), params), psh)
            st = O.adamw_init(opt, lp)
            step = TS.make_train_step(mm, opt)
            C.reset_stats()
            fresh_peak()
            t0 = time.perf_counter()
            lp, st, met = step(lp, st, lb)
            sync(device)
            runs[name] = {"ms": 1e3 * (time.perf_counter() - t0),
                          "loss": float(met["loss"]),
                          "grad_norm": float(met["grad_norm"]),
                          "oracle": oracle[0][name], "peak_bytes": peak(),
                          "collectives": by_axis()}
            del lp, st, met, step
    res["rwkv"] = {
        "config": {"name": cfg.name, "layers": cfg.n_layers,
                   "d_model": cfg.d_model, "heads": cfg.n_heads,
                   "d_ff": cfg.d_ff, "vocab": cfg.vocab,
                   "batch": TRAIN_BATCH, "seq": MESH_RWKV_SEQ,
                   "params": one.param_count()},
        "heads_local": cfg.n_heads // M, **runs}
    del params, b0, lb
    release(device)
    progress("RWKV-6 mesh steps")

    # -- Jamba-v0.1: prefill and decode on the mesh ------------------------
    cfg, cfg_m = cfgs["jamba"]
    one, mm = build_model(cfg), build_model(cfg_m)
    P, T = MESH_JAMBA_PROMPT, MESH_JAMBA_STEPS
    T32 = MESH_F32_STEPS
    gen = torch.Generator(device="cpu").manual_seed(seed + 29)
    tokens = torch.randint(1, cfg.vocab, (D, P + T), generator=gen,
                           dtype=torch.int32).to(device)
    with C.use_mesh(mesh):
        psh = TS.param_shardings(mm, mesh, rules)
        shape = ShapeConfig("mesh", P + T, D, "decode")
        bsh = TS.batch_shardings(mm, shape, mesh, rules)
        specs = tree_map(lambda sh: sh.spec, bsh["cache"])
        tspec = bsh["tokens"].spec
        tok = C.local_of(tokens, tspec)
    # each rank draws the whole model in turn and keeps its blocks; rank 0
    # keeps the whole model on the host
    full, lp = None, None
    for r in range(dist.get_world_size()):
        if r == rank:
            p = one.init(torch.Generator(device=device).manual_seed(
                seed + 23), device)
            with C.use_mesh(mesh):
                lp = shard_params(p, psh)
            if rank == 0:
                full = tree_map(lambda a: a.cpu(), p)
            del p
            release(device)
        dist.barrier()
    progress("Jamba drawn")

    def run_mesh(params, steps):
        """The prefill and ``steps`` decode steps on the mesh: the logits
        of each, the last cache, ms and peaks."""
        out = {"logits": [], "step_ms": []}
        with C.use_mesh(mesh), torch.no_grad():
            fresh_peak()
            t0 = time.perf_counter()
            logits, caches = mm.prefill(params, {"tokens": tok[:, :P]})
            sync(device)
            out["prefill_ms"] = 1e3 * (time.perf_counter() - t0)
            out["prefill_peak_bytes"] = peak()
            out["logits"].append(logits)
            cache = mm.cache_from_prefill(caches, P, P + T)
            del caches
            fresh_peak()
            for t in range(steps):
                t0 = time.perf_counter()
                logits, cache = mm.decode(params, cache,
                                          tok[:, P + t:P + t + 1], P + t,
                                          specs)
                sync(device)
                out["step_ms"].append(1e3 * (time.perf_counter() - t0))
                out["logits"].append(logits)
            out["decode_peak_bytes"] = peak()
        out["cache"] = cache
        return out

    # bf16, K4 counted, each layer on its own input
    moe_io, mamba_io = [], []
    block, mixer = L._moe_block_mesh, Mb.mamba_block

    def recording_block(p, x, **kw):
        o = block(p, x, **kw)
        moe_io.append((x.detach(), o[0].detach()))
        return o

    def recording_mixer(p, x, state, d_state=16, shard_ctx=None):
        o = mixer(p, x, state, d_state, shard_ctx=shard_ctx)
        if x.shape[1] > 1:                 # the prefill: zero state
            mamba_io.append((x.detach().cpu(), o[0].detach().cpu()))
        return o

    L._moe_block_mesh, Mb.mamba_block = recording_block, recording_mixer
    try:
        G.reset_launches()
        C.reset_stats()
        bf = run_mesh(lp, T)
        launches = dict(G.LAUNCHES)
        collectives = by_axis()
    finally:
        L._moe_block_mesh, Mb.mamba_block = block, mixer
    jb = {"config": {"name": cfg.name, "layers": cfg.n_layers,
                     "d_model": cfg.d_model, "d_inner": 2 * cfg.d_model,
                     "d_state": cfg.d_state, "experts": cfg.moe_experts,
                     "topk": cfg.moe_topk, "d_ff": cfg.d_ff,
                     "prompt": P, "steps": T, "batch": D,
                     "params": one.param_count()},
          "launches": launches, "collectives": collectives,
          "bf16": {k: bf[k] for k in ("prefill_ms", "step_ms",
                                      "prefill_peak_bytes",
                                      "decode_peak_bytes")},
          "finite": all(bool(torch.isfinite(x).all())
                        for x in bf["logits"]),
          "state_shapes": sorted({str(list(v.shape)) for k, v in
                                  leaves(bf["cache"])})}
    del bf
    release(device)
    # each MoE layer against the naive dispatch on its input (every rank,
    # over its batch rows; the rank's experts' weights gathered), each
    # Mamba layer's prefill against the one-device block (rank 0)
    moe_rel, mamba_rel = [], []
    if rank == 0:
        pm = {k: v[0].to(device)
              for k, v in full["blocks"]["b1"]["moe"].items()}
        for x, o in moe_io:
            with torch.no_grad():
                want, _ = L.moe_block(pm, x, topk=cfg.moe_topk, impl="naive")
            moe_rel.append(rel_l2(o, want))
        jb["gmm"] = mesh_gmm_check(cfg, pm, moe_io[0][0], M, device)
        del pm
        for i, (x, o) in enumerate(mamba_io):
            pb = {k: v[0].to(device) for k, v in
                  full["blocks"][f"b{i % MESH_JAMBA_LAYERS}"]["mamba"].items()}
            B, di = x.shape[0], pb["in_proj"].shape[1] // 2
            zero = (torch.zeros((B, di, cfg.d_state), device=device),
                    torch.zeros((B, Mb.CONV_K - 1, di), device=device))
            with torch.no_grad():
                want, _ = mixer(pb, x.to(device), zero, cfg.d_state)
            mamba_rel.append(rel_l2(o.to(device), want))
            del pb
    jb["moe_layers_bf16"], jb["mamba_layers_bf16"] = moe_rel, mamba_rel
    progress("Jamba bf16")
    del moe_io, mamba_io
    release(device)

    # f32: the mesh against one device (rank 0's, broadcast).  Its
    # compiled MoE does not bake: a plan keeps a static copy of the
    # experts it reads, which each layer gathers anew (5.6 GB a rank in
    # f32), and four ranks' copies beside their working sets do not fit
    # the card
    from repro_torch import lilac

    L._LILAC_MOE.clear()                 # the bf16 plans and their pools
    L._LILAC_MOE[device.type] = lilac.compile(
        L._moe_naive_2d, platform=device.type, bake=False)
    lp = tree_map(lambda a: a.float(), lp)
    release(device)
    want = [None]
    if rank == 0:
        def to_card(tree):                       # leaf by leaf
            for k, v in tree.items():
                if isinstance(v, dict):
                    to_card(v)
                else:
                    tree[k] = v.to(device).float()

        to_card(full)
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, caches = one.prefill(full, {"tokens": tokens[:, :P]})
            ref = {"logits": [logits.cpu()]}
            cache = one.cache_from_prefill(caches, P, P + T)
            for t in range(T32):
                logits, cache = one.decode(full, cache,
                                           tokens[:, P + t:P + t + 1], P + t)
                ref["logits"].append(logits.cpu())
        ref["cache"] = tree_map(lambda a: a.float().cpu(), cache)
        ref["s"] = time.perf_counter() - t0
        want[0] = ref
        del full, cache, caches, logits
        release(device)
    dist.broadcast_object_list(want, src=0)
    want = want[0]
    progress("Jamba one-device f32")
    G.reset_launches()
    f32 = run_mesh(lp, T32)
    with C.use_mesh(mesh):
        logit_rel = [mesh_rel_l2({"l": g}, {"l": w.to(device)},
                                 {"l": tspec}, names)["l"]
                     for g, w in zip(f32["logits"], want["logits"])]
        cache_rel = mesh_rel_l2(f32["cache"], tree_map(
            lambda a: a.to(device), want["cache"]), specs, names)
    jb["f32"] = {"logits_rel_l2": logit_rel, "cache_rel_l2": cache_rel,
                 "launches": dict(G.LAUNCHES), "oracle_s": want["s"],
                 **{k: f32[k] for k in ("prefill_ms", "step_ms")}}
    res["jamba"] = jb
    del lp, f32, want
    L._LILAC_MOE.clear()
    release(device)
    res["seconds"] = time.perf_counter() - t_start
    return res


def mesh_gmm_check(cfg, p, x, M: int, device, reps: int = 5) -> dict:
    """K4 on rank 0's experts at the Jamba mesh prefill's shapes (the MoE
    layer's input, its routes by the whole router, other ranks' pairs at
    local expert 0, as the mesh path hands them to K4) against its plain
    version, timed, with torch._grouped_mm beside it."""
    import torch
    from repro_torch.kernels.moe_gmm import kernel as G
    from repro_torch.kernels.moe_gmm import ref as GR
    from repro_torch.kernels.moe_gmm.ops import _route
    from repro_torch.models import layers as L

    E, K, tm = cfg.moe_experts, cfg.moe_topk, 128
    E_loc = -(-E // M)
    seq = x.shape[1]
    with torch.no_grad():
        _, idx, _ = L.moe_router(p, x, K)
    lidx = idx[0].long()
    mine = lidx < E_loc                  # rank 0: experts [0, E_loc)
    lidx = torch.where(mine, lidx, 0)
    dest, te, tp = _route(lidx, seq, K, E_loc, tm)
    xs = torch.zeros((tp, cfg.d_model), dtype=x.dtype, device=device)
    xs[dest] = x[0].repeat_interleave(K, dim=0)
    w0 = p["wg"][:E_loc]
    routed = int(mine.sum())
    nb = routed * cfg.d_model * 2 + nbytes(w0) + routed * cfg.d_ff * 4
    out = {"name": "gmm", "tp": tp, "routed_rows": routed,
           "library_ms": None, "variants": {
               "gate_up": variant_numbers(
                   lambda: G.gmm_cuda(xs, w0, te, tm),
                   lambda: GR.gmm_ref(xs, w0, te, tm), "gmm_tc_kernel",
                   device.type == "cuda", reps, nb,
                   2 * routed * cfg.d_model * cfg.d_ff, xs.dtype, GMM_ATOL,
                   GMM_RTOL, what="gmm on rank 0's Jamba experts",
                   sum_scale=GR.gmm_ref(xs.abs(), w0.abs(), te, tm))}}
    grouped = getattr(torch, "_grouped_mm", None)
    if device.type == "cuda" and grouped is not None:
        counts = torch.bincount(lidx.reshape(-1), minlength=E_loc)
        offs = torch.cumsum((counts + tm - 1) // tm * tm, 0).to(torch.int32)
        out["library_ms"] = cuda_ms(lambda: grouped(xs, w0, offs=offs),
                                    reps)[0]
    return out


def dist_dryrun_cells(mesh_shape=DIST_MESH) -> dict:
    """The dry-run's accounting of rank 0 of the recurrent phase's steps,
    at the same configurations and local shapes: peak memory, and each
    mixer's forward FLOPs as the step runs them and as the replicated
    route ran them before their partition (the same cell at a model axis
    of 1: each model rank computed the whole mixer on its data shard)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as DR

    D, M = mesh_shape
    cfgs = _mesh_cfgs(D, M)
    cells = {"rwkv train": ("rwkv", ShapeConfig("mesh", MESH_RWKV_SEQ,
                                                TRAIN_BATCH, "train")),
             "jamba prefill": ("jamba", ShapeConfig(
                 "mesh", MESH_JAMBA_PROMPT, D, "prefill")),
             "jamba decode": ("jamba", ShapeConfig(
                 "mesh", MESH_JAMBA_PROMPT + MESH_JAMBA_STEPS, D, "decode"))}
    out = {}
    for name, (fam, shape) in cells.items():
        cfg = cfgs[fam][1]
        over = {k: getattr(cfg, k) for k in (
            "n_layers", "attn_layer_period", "moe_impl", "moe_decode_impl",
            "remat")}
        row = {}
        for route, m in (("partitioned", M), ("replicated", 1)):
            r = DR.analyze_cell(cfg.name, "train_4k", False,
                                arch_overrides=dict(over, microbatches=1),
                                axis_sizes={"data": D, "model": m},
                                shape=shape)
            row[route] = {"flops": r["flops"], "memory": r["memory"],
                          "mixer_forward_flops": r["mixer_forward_flops"]}
        out[name] = row
    return out


def run_dist_phase(seed: int, work: str, timeout: int = 900) -> dict:
    """The distributed phase: DIST_RANKS processes of this script under
    torchrun (gloo, all on this card), the ranks' results in one JSON,
    and the dry-run's cells (``dist_dryrun_cells``) computed here while
    the ranks run."""
    out = Path(work) / "dist.json"
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True",
               LILAC_TORCH_AUTOTUNE_CACHE=str(
        Path(work) / "autotune-dist.json"),
        LILAC_TORCH_PLAN_CACHE=str(Path(work) / "plans-dist.json"),
        LILAC_TORCH_QUARANTINE_CACHE=str(Path(work) / "quarantine-dist.json"))
    t0 = time.perf_counter()
    p = subprocess.Popen([sys.executable, "-m", "torch.distributed.run",
                          "--standalone", "--nproc-per-node", str(DIST_RANKS),
                          str(Path(__file__).resolve()), "--seed", str(seed),
                          "--dist-phase", "--dist-out", str(out)],
                         env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
    try:
        # the dry-run's accounting of the same cells, on the host meanwhile
        cells = dist_dryrun_cells()
        _, stderr = p.communicate(timeout=timeout)
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    if p.returncode != 0:
        # the ranks' first traceback, before torchrun's own report
        first = max(stderr.find("Traceback"), 0)
        raise RuntimeError(f"distributed phase failed:\n"
                           f"{stderr[first:first + 6000]}")
    ranks = json.loads(out.read_text())
    return {"ranks": ranks, "cells": cells,
            "seconds": time.perf_counter() - t0}


def dist_phase_main(seed: int, out: Path) -> int:
    """A rank of the distributed phase (under torchrun)."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed

    rank = init_distributed("gloo", "cuda")
    work = str(out.parent)
    with fault_free(f"distributed training, rank {rank}"):
        res = dist_path(seed, torch.device("cuda"), work)
    release(torch.device("cuda"))
    with fault_free(f"distributed recurrent mixers, rank {rank}"):
        res["recurrent"] = dist_recurrent_path(seed, torch.device("cuda"))
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, res)
    if rank == 0:
        out.write_text(json.dumps(ranks, default=str))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def print_dist_path(dr) -> None:
    r0 = dr["ranks"][0]
    c = r0["config"]
    print(f"distributed {c['name']} (d_model {c['d_model']}, {c['experts']} "
          f"experts top-{c['topk']}) cut to {c['layers']} layers, "
          f"{c['params']} params, batch {c['batch']} x seq {c['seq']}, "
          f"moe_impl=lilac via {r0['moe_selections']}, mesh (data, model) = "
          f"{tuple(r0['mesh'])}, sequence parallel; gloo, {DIST_RANKS} ranks "
          f"on one card, host-staged collectives")
    print(f"distributed first step: loss {r0['loss_mesh']:.6f} against the "
          f"one-device step's {r0['loss_one_device']:.6f} (rel "
          f"{r0['loss_rel']:.3g}, tol {TRAIN_LOSS_RTOL}); worst gradient "
          f"leaf relative L2 {r0['grad_rel_l2_max']:.3g} at "
          f"{r0['grad_rel_l2_worst']} (tol {TRAIN_GRAD_RTOL}; the largest "
          f"{r0['grad_rel_l2_top']}); tokens routed to another top-k set "
          f"than in the one-device step, by rank and layer "
          f"{[r['route_flips'] for r in dr['ranks']]} of {c['seq']} a "
          f"sequence; MoE layers "
          f"against the naive dispatch, relative L2 {r0['moe_layers']} (tol "
          f"{MOE_RTOL})")
    for r in dr["ranks"]:
        v = r["gmm"]["variants"]["gate_up"]
        print(f"distributed rank {r['rank']}: K4 launches first step "
              f"{r['first_step_launches']}, by step "
              f"{[s['launches'].get('gmm', 0) for s in r['steps']]} (the "
              f"block vmaps its sequences; the per-sequence loop: "
              f"{3 * c['layers'] * (c['batch'] // DIST_MESH[0])} a step); routed "
              f"rows of its experts by layer and sequence {r['routed_rows']} "
              f"against K4's Tp {r['tp']} a sequence; K4 on its experts vs "
              f"plain max|err| {v['max_abs_err']:.3g} (scaled "
              f"{v['scaled_err']:.3g}), {_ms(v['ms'])} ms; peak "
              f"{r['peak_bytes'] / 2**30:.2f} GiB; first step "
              f"{r['first_step_s']:.2f}s, oracle {r['oracle_s']:.2f}s; "
              f"save {r['save_s']:.1f}s, restore {r['restore_s']:.1f}s")
    for i, st in enumerate(r0["steps"]):
        print(f"distributed step {i}: {st['ms']:.1f} ms (gloo, {DIST_RANKS} "
              f"ranks on one card, host-staged collectives), loss "
              f"{st['loss']:.6f}, grad norm {st['grad_norm']:.4g}, "
              f"collective payload {st['collective_bytes'] / 2**30:.2f} GiB "
              f"a rank, peak {max(r['steps'][i]['peak_bytes'] for r in dr['ranks']) / 2**30:.2f} "
              f"GiB (the largest rank's)")
    cs = r0["compiled"]
    first = r0["compiled_steps"][0]["loss"]
    print(f"distributed compiled step ({cs['backend']}): {cs['compiles']} "
          f"graphs, {cs['graph_breaks']} graph breaks (the host-staged "
          f"collectives and torch.autograd.grad), by rank "
          f"{[(r['compiled']['compiles'], r['compiled']['graph_breaks']) for r in dr['ranks']]}; "
          f"first step (its compile and run) {cs['compile_seconds']:.1f}s; "
          f"losses {[st['loss'] for st in r0['compiled_steps']]}, the first "
          f"against the uncompiled mesh step's {r0['steps'][0]['loss']:.6f} "
          f"(rel {abs(first - r0['steps'][0]['loss']) / abs(r0['steps'][0]['loss']):.3g}); "
          f"K4 launches by step "
          f"{[st['launches'].get('gmm', 0) for st in r0['compiled_steps']]}")
    print(f"distributed checkpoint: saved at {tuple(r0['mesh'])}, restored "
          f"onto ({DIST_RANKS}, 1) bit for bit on every rank: "
          f"{all(r['restore_mesh_equal'] for r in dr['ranks'])}, onto one "
          f"device: {r0['restore_one_device_equal']}; phase "
          f"{dr['seconds']:.1f}s")


def check_dist_path(dr, steps: int = DIST_STEPS) -> None:
    ranks = dr["ranks"]
    require(len(ranks) == DIST_RANKS, f"distributed: {DIST_RANKS} ranks' "
            f"results, got {len(ranks)}")
    r0 = ranks[0]
    require(r0["loss_rel"] <= TRAIN_LOSS_RTOL,
            f"distributed: the first loss within {TRAIN_LOSS_RTOL} of the "
            f"one-device step's, got {r0['loss_mesh']} against "
            f"{r0['loss_one_device']}")
    require(r0["grad_rel_l2_max"] <= TRAIN_GRAD_RTOL,
            f"distributed: every gradient leaf within relative L2 "
            f"{TRAIN_GRAD_RTOL} of the one-device step's, got "
            f"{r0['grad_rel_l2_max']:.3g} at {r0['grad_rel_l2_worst']}")
    require(max(r0["moe_layers"]) <= MOE_RTOL,
            f"distributed: each MoE layer within relative L2 {MOE_RTOL} of "
            f"the naive dispatch, got {r0['moe_layers']}")
    for r in ranks:
        require(r["grads_finite"] and r["moe_selections"] == ["cuda.gmm"],
                f"distributed rank {r['rank']}: finite gradients and the "
                f"inner MoE on cuda.gmm, got {r['moe_selections']}")
        require(r["first_step_launches"].get("gmm", 0) > 0
                and len(r["steps"]) == steps
                and all(s["launches"].get("gmm", 0) > 0 for s in r["steps"]),
                f"distributed rank {r['rank']}: K4 launched in every step, "
                f"got {r['first_step_launches']} and "
                f"{[s['launches'] for s in r['steps']]}")
        require(all(abs(s["loss"]) < float("inf") for s in r["steps"]),
                f"distributed rank {r['rank']}: finite losses")
        require(r["restore_mesh_equal"],
                f"distributed rank {r['rank']}: the (2, 2) checkpoint "
                f"restored onto ({DIST_RANKS}, 1) bit for bit")
    require(r0["restore_one_device_equal"],
            "distributed: the (2, 2) checkpoint restored onto one device "
            "bit for bit")
    for r in ranks:
        c, cst = r["compiled"], r["compiled_steps"]
        first, eager = cst[0]["loss"], r["steps"][0]["loss"]
        require(len(cst) == DIST_COMPILED_STEPS and c["graph_breaks"] > 0
                and c["calls"] == DIST_COMPILED_STEPS
                and all(s["launches"].get("gmm", 0)
                        == r["steps"][0]["launches"].get("gmm", 0)
                        for s in cst)
                and abs(first - eager) <= TRAIN_LOSS_RTOL * abs(eager),
                f"distributed rank {r['rank']}: the compiled mesh step, its "
                f"breaks counted, K4 launched as the uncompiled step does, "
                f"its first loss within {TRAIN_LOSS_RTOL} of the uncompiled "
                f"step's, got {c}, {cst} against {r['steps'][0]}")


def print_dist_recurrent(dr, cells, smi: str) -> None:
    rs = [r["recurrent"] for r in dr["ranks"]]
    r0 = rs[0]
    w, c = r0["rwkv"], r0["rwkv"]["config"]

    def vs(run, key):
        got, want = run[key], run["oracle"][key]
        return (f"{key.replace('_', ' ')} {got:.6g} against {want:.6g} "
                f"(rel {abs(got - want) / abs(want):.3g})")
    b, f = w["bf16"], w["f32"]
    print(f"distributed {c['name']} (d_model {c['d_model']}, {c['heads']} "
          f"heads, d_ff {c['d_ff']}, vocab {c['vocab']}) cut to "
          f"{c['layers']} layers, {c['params']} params, batch {c['batch']} x "
          f"seq {c['seq']}, mesh {DIST_MESH}: the time mix by heads "
          f"({w['heads_local']} a rank), the channel mix by d_ff; one mesh "
          f"step against rank 0's one-device step, f32: {f['ms']:.1f} ms, "
          f"{vs(f, 'loss')}, {vs(f, 'grad_norm')} (tol {TRAIN_LOSS_RTOL}, "
          f"{TRAIN_GRAD_RTOL}); bf16: {b['ms']:.1f} ms, {vs(b, 'loss')}, "
          f"{vs(b, 'grad_norm')}; the one-device bf16 step's grad norm "
          f"against its f32 step's: rel "
          f"{abs(b['oracle']['grad_norm'] - f['oracle']['grad_norm']) / f['oracle']['grad_norm']:.3g}"
          f" ({smi}); collectives by axis (bf16) {b['collectives']}")
    j, c = r0["jamba"], r0["jamba"]["config"]
    f = j["f32"]
    med = lambda v: sorted(v)[len(v) // 2]
    print(f"distributed {c['name']} (d_model {c['d_model']}, d_inner "
          f"{c['d_inner']}, d_state {c['d_state']}, {c['experts']} experts "
          f"top-{c['topk']}, d_ff {c['d_ff']}) cut to {c['layers']} layers "
          f"(Mamba + MLP, Mamba + MoE), {c['params']} params, one prompt of "
          f"{c['prompt']} a data rank, {c['steps']} decode steps, mesh "
          f"{DIST_MESH}: Mamba by its inner dim, the MoE by experts on K4; "
          f"bf16 prefill {j['bf16']['prefill_ms']:.1f} ms, decode step p50 "
          f"{med(j['bf16']['step_ms']):.1f} ms ({smi}); K4 launches by rank "
          f"{[r['jamba']['launches'] for r in rs]}; state blocks a rank "
          f"{j['state_shapes']}; each MoE layer against the naive dispatch "
          f"(bf16) {[f'{v:.3g}' for v in j['moe_layers_bf16']]}, each Mamba "
          f"layer's prefill against the one-device block "
          f"{[f'{v:.3g}' for v in j['mamba_layers_bf16']]} (tol {MOE_RTOL}); "
          f"f32 against the one-device model over the prefill and "
          f"{MESH_F32_STEPS} decode steps: logits relative L2 max "
          f"{max(f['logits_rel_l2']):.3g} (prefill "
          f"{f['logits_rel_l2'][0]:.3g}), cache leaves max "
          f"{max(f['cache_rel_l2'].values()):.3g} (tol {MESH_F32_RTOL}), K4 "
          f"f32 launches {f['launches']}, prefill {f['prefill_ms']:.1f} ms, "
          f"decode step p50 {med(f['step_ms']):.1f} ms; collectives by axis "
          f"(bf16) {j['collectives']}")
    g = j["gmm"]
    print_variants(g, f"tol atol={GMM_ATOL} + rtol={GMM_RTOL}*|ref|")
    print(f"gmm at the Jamba mesh prefill (rank 0's {c['experts'] // DIST_MESH[1]}"
          f" experts, {g['routed_rows']} routed rows in Tp {g['tp']}): "
          f"torch._grouped_mm {g['library_ms']} ms")
    gib = 2.0 ** 30
    for r in rs:
        print(f"distributed rank {r['rank']} peak memory, measured "
              f"(torch.cuda.max_memory_allocated) against the dry-run's "
              f"peak_memory_in_bytes: RWKV-6 bf16 step "
              f"{r['rwkv']['bf16']['peak_bytes'] / gib:.3f} against "
              f"{cells['rwkv train']['partitioned']['memory']['peak_memory_in_bytes'] / gib:.3f} GiB, "
              f"Jamba prefill {r['jamba']['bf16']['prefill_peak_bytes'] / gib:.3f}"
              f" against {cells['jamba prefill']['partitioned']['memory']['peak_memory_in_bytes'] / gib:.3f}"
              f", decode {r['jamba']['bf16']['decode_peak_bytes'] / gib:.3f} "
              f"against {cells['jamba decode']['partitioned']['memory']['peak_memory_in_bytes'] / gib:.3f}"
              f"; mixer forward FLOPs of the rank, replicated (before the "
              f"partition) -> partitioned: " + "; ".join(
                  f"{cell} " + ", ".join(
                      f"{k} {row['replicated']['mixer_forward_flops'][k]:.4g}"
                      f" -> {v:.4g}"
                      for k, v in row["partitioned"][
                          "mixer_forward_flops"].items())
                  for cell, row in cells.items()))
    print(f"distributed recurrent mixers: rank 0's part "
          f"{r0['seconds']:.1f}s")


def check_dist_recurrent(dr, cells) -> None:
    for r in (x["recurrent"] for x in dr["ranks"]):
        w = r["rwkv"]["f32"]
        o = w["oracle"]
        require(abs(w["loss"] - o["loss"]) <= TRAIN_LOSS_RTOL * abs(o["loss"])
                and abs(w["grad_norm"] - o["grad_norm"])
                <= TRAIN_GRAD_RTOL * abs(o["grad_norm"]),
                f"distributed RWKV-6 rank {r['rank']}: the f32 mesh step's "
                f"loss within {TRAIN_LOSS_RTOL} and grad norm within "
                f"{TRAIN_GRAD_RTOL} of the one-device step's, got "
                f"{w['loss']}, {w['grad_norm']} against {o}")
        require(all("all_gather" not in r["rwkv"][k]["collectives"].get(
                    "model", {}) for k in ("bf16", "f32")),
                f"distributed RWKV-6 rank {r['rank']}: nothing gathered "
                f"over the model axis, got {r['rwkv']}")
        j = r["jamba"]
        require(j["launches"].get("gmm", 0) > 0
                and j["f32"]["launches"].get("gmm_f32", 0) > 0 and j["finite"],
                f"distributed Jamba rank {r['rank']}: K4 launched in bf16 "
                f"and in f32, finite logits, got {j['launches']} and "
                f"{j['f32']['launches']}")
        require(max(j["f32"]["logits_rel_l2"]) <= MESH_F32_RTOL
                and max(j["f32"]["cache_rel_l2"].values()) <= MESH_F32_RTOL,
                f"distributed Jamba rank {r['rank']}: the f32 logits and "
                f"every new cache leaf within {MESH_F32_RTOL} of the "
                f"one-device model, got {j['f32']['logits_rel_l2']} and "
                f"{j['f32']['cache_rel_l2']}")
        c = j["config"]
        di = c["d_inner"] // DIST_MESH[1]
        require(j["state_shapes"] == sorted({f"[1, 3, {di}]",
                                             f"[1, {di}, {c['d_state']}]"}),
                f"distributed Jamba rank {r['rank']}: the state the rank's "
                f"block of d_inner, got {j['state_shapes']}")
        for cell, got in (("rwkv train", r["rwkv"]["bf16"]["peak_bytes"]),
                          ("jamba prefill", j["bf16"]["prefill_peak_bytes"]),
                          ("jamba decode", j["bf16"]["decode_peak_bytes"])):
            want = cells[cell]["partitioned"]["memory"]["peak_memory_in_bytes"]
            require(want / DRYRUN_PEAK_FACTOR <= got
                    <= want * DRYRUN_PEAK_FACTOR,
                    f"distributed rank {r['rank']} {cell}: the measured peak "
                    f"within a factor of {DRYRUN_PEAK_FACTOR} of the "
                    f"dry-run's, got {got} against {want} bytes")
    j = dr["ranks"][0]["recurrent"]["jamba"]
    require(len(j["moe_layers_bf16"]) == 1 + MESH_JAMBA_STEPS
            and len(j["mamba_layers_bf16"]) == MESH_JAMBA_LAYERS
            and max(j["moe_layers_bf16"] + j["mamba_layers_bf16"]) <= MOE_RTOL,
            f"distributed Jamba: each bf16 layer on its own input within "
            f"{MOE_RTOL}, got {j['moe_layers_bf16']} and "
            f"{j['mamba_layers_bf16']}")
    for name, row in cells.items():
        mem = row["partitioned"]["memory"]
        require(mem["peak_memory_in_bytes"] >= mem["argument_size_in_bytes"]
                and all(v < row["replicated"]["mixer_forward_flops"][k]
                        for k, v in row["partitioned"][
                            "mixer_forward_flops"].items()),
                f"dry-run {name}: a peak of at least the arguments, each "
                f"mixer's FLOPs below its replicated count, got {row}")


def train_line(s) -> str:
    return (f"{s['ms']:.2f} ms, loss {s['loss']:.6f}, grad norm "
            f"{s['grad_norm']:.4g}, peak {s['peak_bytes'] / 2**30:.2f} GiB")


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


# ---------------------------------------------------------------------------
# The How language's lifecycle: a hook-bearing harness on K1 (Fig. 14)
# ---------------------------------------------------------------------------

LIFECYCLE_SPEC = """
HARNESS lifecycle.ell implements spmv_csr
  formats CSR;
  host_only;
  persistent layout;
  BeforeFirstExecution lifecycle_ell_setup;
  AfterLastExecution lifecycle_ell_teardown;
"""
READ_CHECK_CALLS = 50
LIFECYCLE_MEMORY_SLACK = 1 << 20    # the allocator's rounding, generously


def lifecycle_path(a, b, seed: int, device, iters: int = CG_ITERS,
                   reps: int = 20) -> dict:
    """A library's stateful backend in the How language: a HARNESS block
    with ``persistent layout``, ``BeforeFirstExecution`` (registered with
    ``@lilac.hook``) and ``AfterLastExecution`` (through ``hooks=``) on a
    fresh registry, whose setup puts a ReadObject in ``persistent
    ["layout"]``: construct packs K1's staged layout from the matched CSR,
    update re-packs it on a change of the values, destruct lets it go.
    The body runs K1 on that layout.  Then: the CG through it (host mode,
    policy = that harness), an in-place edit of the values, the teardown
    that ``register(..., override=True)`` runs, the memory before setup
    and after it; ``enabled=False``; the keyword and CompileOptions forms
    of one compile; and the call times of the hook-bearing harness (it
    cannot bake), of the baked cuda.ell plan and of the ReadObject's
    change check."""
    import gc
    import types

    import torch
    from repro_torch import lilac
    from repro_torch.core.harness import _binding_to_csr
    from repro_torch.core.rewrite import fused_bias
    from repro_torch.kernels.bsr_spmm import kernel as B
    from repro_torch.kernels.moe_gmm import kernel as G
    from repro_torch.kernels.spmv_ell import kernel as K
    from repro_torch.kernels.spmv_ell.ops import pack_ell128, spmv_ell_packed

    on_card = device.type == "cuda"
    counters = (K, B, G)
    out = {}
    rng = torch.Generator(device="cpu").manual_seed(seed + 7)
    p = torch.randn(a.cols, generator=rng).to(device)
    args = (a.val, a.col_ind, a.row_ptr, p)

    def launches():
        return sum(sum(c.LAUNCHES.values()) for c in counters)

    # the keyword and the options form of one compile (a policy the
    # device has), and the baked plan's call time
    policy = "cuda.ell" if on_card else "torch.ell"
    kw = lilac.compile(naive_spmv, mode="host", policy=policy, device=device)
    op = lilac.compile(naive_spmv, options=lilac.CompileOptions(
        mode="host", policy=policy, device=device))
    outs = [[f(*args) for _ in range(3)] for f in (kw, op)]
    out["options"] = {
        "policy": policy,
        "equal": all(torch.equal(x, y) for x, y in zip(*outs)),
        "selections": [[n for _, n in f.last_selections] for f in (kw, op)],
        "baked": [f.plan_info()["baked"] for f in (kw, op)]}
    out["options"]["same_selection"] = (
        out["options"]["selections"][0] == out["options"]["selections"][1])
    out["baked_call_ms"] = cuda_ms(lambda: kw(*args), reps) if on_card \
        else (None, None)
    del kw, op, outs
    release(device)

    # enabled=False: the function itself, no detection, no launch (the
    # naive SpMV's index_add_ sums by atomics on the card: deterministic
    # algorithms make two runs of it comparable bit for bit)
    off = lilac.compile(naive_spmv, enabled=False, device=device)
    for c in counters:
        c.reset_launches()
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        got, want = off(*args), naive_spmv(*args)
    finally:
        torch.use_deterministic_algorithms(deterministic)
    out["disabled"] = {
        "equal": bool(torch.equal(got, want)),
        "detects": off.stats["detects"], "traces": off.stats["traces"],
        "launches": launches()}
    del off, got, want

    # the hook-bearing harness on a registry of its own
    events = dict.fromkeys(("setups", "constructs", "updates", "destructs",
                            "teardowns"), 0)
    binding = {}

    def pack(val):
        return pack_ell128(_binding_to_csr(binding["b"]))

    def construct(val):
        events["constructs"] += 1
        return pack(val)

    def update(val, layout):
        events["updates"] += 1
        return pack(val)

    def destruct(layout):
        events["destructs"] += 1

    @lilac.hook("lifecycle_ell_setup", override=True)
    def setup(state):
        events["setups"] += 1
        state["layout"] = lilac.ReadObject(construct, update, destruct)

    def teardown(state):
        events["teardowns"] += 1
        state["layout"].release()
        state["layout"] = None

    registry = lilac.HarnessRegistry()
    hooks = {"lifecycle_ell_teardown": teardown}

    def body(bd, ctx):
        binding["b"] = bd
        layout = harness.persistent["layout"].read(bd["a"])
        return spmv_ell_packed(layout, bd["iv"], epilogue=ctx.epilogue,
                               bias=fused_bias(bd, ctx))

    (harness,) = lilac.register_spec(LIFECYCLE_SPEC,
                                     {"lifecycle.ell": body},
                                     registry=registry, hooks=hooks)
    fast = lilac.compile(naive_spmv, mode="host", policy="lifecycle.ell",
                         registry=registry, device=device)
    # the naive CG first: what it allocates for good (cuBLAS's workspace
    # at its first product) is not the backend's
    x_ref = cg(naive_spmv, a, b, iters)
    sync(device)
    gc.collect()
    mem0 = torch.cuda.memory_allocated(device) if on_card else None
    for c in counters:
        c.reset_launches()
    calls: list = []
    x = cg(timed(fast, calls, device), a, b, iters)
    out["launches"] = K.LAUNCHES["spmv_ell_staged"]
    out["all_launches"] = launches()
    out.update(events)
    layout = harness.persistent["layout"].read(a.val)
    out.update(
        rel_to_naive=rel_l2(x, x_ref), finite=bool(torch.isfinite(x).all()),
        selections=[n for _, n in fast.last_selections],
        match=[(m.computation, m.format) for m in fast.last_report.matches],
        plan_info={k: v for k, v in fast.plan_info().items()
                   if k in ("entries", "baked", "no_bake", "bake_errors")},
        steady_call_ms=steady_ms(calls), first_call_s=calls[0],
        layout_bytes=layout_bytes(layout),
        mem_with_layout=(torch.cuda.memory_allocated(device) if on_card
                         else None))
    del layout
    out["call_ms"] = cuda_ms(lambda: fast(*args), reps) if on_card \
        else (None, None)
    ro = harness.persistent["layout"]
    sync(device)
    t0 = time.perf_counter()
    for _ in range(READ_CHECK_CALLS):
        ro.read(a.val)
    sync(device)
    out["read_check_ms"] = 1e3 * (time.perf_counter() - t0) / READ_CHECK_CALLS
    out["events_after_timing"] = dict(events)

    # the values scaled in place (a copy: later phases keep the matrix)
    edited = types.SimpleNamespace(val=a.val.clone(), col_ind=a.col_ind,
                                   row_ptr=a.row_ptr)
    fast(edited.val, a.col_ind, a.row_ptr, p)
    before = dict(events)
    edited.val.mul_(2)
    xe = cg(fast, edited, b, iters)
    xe_ref = cg(naive_spmv, edited, b, iters)
    out["edit"] = {
        "updates": events["updates"] - before["updates"],
        "constructs": events["constructs"] - before["constructs"],
        "rel_to_naive": rel_l2(xe, xe_ref)}
    del x, xe, xe_ref, edited, ro

    # override=True replaces the live backend: its teardown runs once
    (again,) = lilac.register_spec(LIFECYCLE_SPEC, {"lifecycle.ell": body},
                                   registry=registry, hooks=hooks,
                                   override=True)
    out["after_override"] = dict(events)
    harness.release()
    again.release()              # never started: no hook runs
    del fast, harness, again, registry
    binding.clear()              # the last call's operands
    gc.collect()
    sync(device)
    out["after_release"] = dict(events)
    if on_card:
        out["memory"] = {"before_setup": mem0,
                         "with_layout": out.pop("mem_with_layout"),
                         "after_release": torch.cuda.memory_allocated(device)}
    else:
        out.pop("mem_with_layout")
    del x_ref
    lilac.HOOKS.pop("lifecycle_ell_setup", None)
    return out


def check_lifecycle_path(res, iters: int = CG_ITERS) -> None:
    calls = iters + 1
    require(res["launches"] == calls,
            f"lifecycle: K1's staged body launched once per SpMV of the CG "
            f"({calls}), got {res['launches']}")
    require(res["match"] == [("spmv_csr", "CSR")]
            and res["selections"] == ["lifecycle.ell"],
            f"lifecycle: one spmv_csr/CSR match on lifecycle.ell, got "
            f"{res['match']} via {res['selections']}")
    require(res["setups"] == 1 and res["constructs"] == 1
            and res["updates"] == 0,
            f"lifecycle: setup once, construct once, no update over the "
            f"CG, got {res}")
    require(res["finite"] and res["rel_to_naive"] <= CG_RTOL,
            f"lifecycle: the CG iterate within {CG_RTOL} of the naive CG, "
            f"got {res['rel_to_naive']:.3g}")
    pi = res["plan_info"]
    require(pi["baked"] == 0 and pi["no_bake"] == 1 and any(
        "lifecycle.ell" in e and "lifecycle hooks" in e
        for e in pi["bake_errors"]),
            f"lifecycle: the hook-bearing harness never bakes and "
            f"plan_info says why, got {pi}")
    ev = res["events_after_timing"]
    require(ev["setups"] == 1 and ev["constructs"] == 1
            and ev["updates"] == 0,
            f"lifecycle: the timed calls and change checks set up and pack "
            f"nothing more, got {ev}")
    e = res["edit"]
    require(e["updates"] == 1 and e["constructs"] == 0
            and e["rel_to_naive"] <= CG_RTOL,
            f"lifecycle: val scaled in place updates the layout once and "
            f"the CG matches the naive one on the edited matrix, got {e}")
    ao, ar = res["after_override"], res["after_release"]
    require(ao["teardowns"] == 1 and ao["destructs"] == 1
            and ar["teardowns"] == 1 and ar["setups"] == 1,
            f"lifecycle: register(..., override=True) tears the backend "
            f"down once and release() runs no second teardown, got {ao}, "
            f"{ar}")
    if "memory" in res:
        m = res["memory"]
        require(abs(m["after_release"] - m["before_setup"])
                <= LIFECYCLE_MEMORY_SLACK,
                f"lifecycle: device memory back to its level before setup "
                f"after the teardown (within {LIFECYCLE_MEMORY_SLACK} B), "
                f"got {m}")
    d = res["disabled"]
    require(d["equal"] and d["detects"] == d["traces"] == 0
            and d["launches"] == 0,
            f"lifecycle: enabled=False returns the function's own bits with "
            f"no trace, detection or launch, got {d}")
    o = res["options"]
    require(o["equal"] and o["same_selection"]
            and o["selections"][0] == ["cuda.ell"]
            and o["baked"] == [1, 1],
            f"lifecycle: CompileOptions gives the keyword form's bits, "
            f"selection (cuda.ell) and baking, got {o}")


def print_lifecycle_path(lc) -> None:
    print(f"lifecycle (npb CG, policy=lifecycle.ell, host mode): match "
          f"{lc['match']} via {lc['selections']}; setups {lc['setups']}, "
          f"constructs {lc['constructs']}, updates {lc['updates']}; K1 "
          f"staged launches {lc['launches']} (all kernels "
          f"{lc['all_launches']}); |x-x_naive|/|x_naive| = "
          f"{lc['rel_to_naive']:.3g}; plan_info {lc['plan_info']}; layout "
          f"{lc['layout_bytes']} B")
    print(f"lifecycle call times: hook-bearing harness (interpreted) "
          f"{lc['steady_call_ms']:.4f} ms a CG call (host clock to a sync), "
          f"{_ms(lc['call_ms'][0])} ms device / {_ms(lc['call_ms'][1])} ms "
          f"host enqueue a call; the baked {lc['options']['policy']} plan "
          f"{_ms(lc['baked_call_ms'][0])} ms device / "
          f"{_ms(lc['baked_call_ms'][1])} ms host; the ReadObject's change "
          f"check {lc['read_check_ms']:.4f} ms a read (host clock)")
    print(f"lifecycle val.mul_(2) in place: {lc['edit']}; after "
          f"override=True {lc['after_override']}; after release() "
          f"{lc['after_release']}; memory {lc.get('memory')}")
    print(f"lifecycle enabled=False: {lc['disabled']}; CompileOptions "
          f"against the keyword form: {lc['options']}")


# ---------------------------------------------------------------------------
# Scans: the CG compiled whole as one torch scan (K1, K2); an ELL layer's
# loop in trace mode (K1's direct body inside the rewritten scan)
# ---------------------------------------------------------------------------

#: (matrix, the body K1/K2 takes there) of the scan phase's CGs
SCAN_CASES = (("npb", "spmv_ell_staged"), ("hpcg", "spmv_ell_windowed"))
SCAN_LAYER_STEPS = 8                # the ELL layer's loop in trace mode


def cg_scan(val, col, row_ptr, b, iters: int = CG_ITERS):
    """``cg`` written as one loop a compiler can take whole: x0, r0, p0,
    then one torch scan of ``iters`` steps over the naive SpMV, whose step
    closes over the matrix.  A carry may not alias another (p0 is a copy
    of r0), nor a step return one of its inputs as it is."""
    import torch
    from torch._higher_order_ops.scan import scan

    x = torch.zeros_like(b)
    r = b - naive_spmv(val, col, row_ptr, x)
    p = r.clone()
    rs = torch.dot(r, r)

    def step(carry, _):
        x, r, p, rs = carry
        ap = naive_spmv(val, col, row_ptr, p)
        alpha = rs / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.dot(r, r)
        return (x, r, r + (rs_new / rs) * p, rs_new), ()

    (x, _, _, _), _ = scan(step, (x, r, p, rs),
                           torch.arange(iters, device=b.device))
    return x


def ell_scan(val, col, v0, bias, steps: int = SCAN_LAYER_STEPS):
    """``ell_layer`` iterated ``steps`` times in a torch scan, each output
    scaled by its largest magnitude and fed back as the next vector."""
    import torch
    from torch._higher_order_ops.scan import scan

    def step(v, _):
        y = ell_layer(val, col, v, bias)
        return y / y.abs().max(), ()

    out, _ = scan(step, v0, torch.arange(steps, device=v0.device))
    return out


def eager_scan_step_calls(length: int = 3) -> int:
    """How many times ``torch.ops.higher_order.scan``, run eagerly, calls
    its step for ``length`` steps: torch 2.11 calls it once more than the
    length (its first call only infers the outputs' shapes), torch 2.13
    ``length`` times.  A trace-mode graph runs its scan so."""
    import torch

    calls = [0]

    def step(c, x):
        calls[0] += 1
        return [c + x]

    torch.ops.higher_order.scan(step, [torch.zeros(())], [torch.ones(length)],
                                ())
    return calls[0]


def _detect_spy():
    """(calls, restore): ``Detector.detect`` counted until ``restore()``."""
    from repro_torch.core import detect as D

    calls = {"n": 0}
    real = D.Detector.detect

    def spy(self, *a, **kw):
        calls["n"] += 1
        return real(self, *a, **kw)

    D.Detector.detect = spy
    return calls, lambda: setattr(D.Detector, "detect", real)


def _host_ms(fn, device, reps: int):
    """Median ms of ``reps`` calls of ``fn``, each on the host's clock from
    a sync to a sync, after one call."""
    calls: list = []
    call = timed(fn, calls, device)
    for _ in range(reps + 1):
        call()
    return steady_ms(calls)


def scan_path(mats, x_refs, seed: int, device, iters: int = CG_ITERS,
              steps: int = SCAN_LAYER_STEPS, reps: int = 3) -> dict:
    """The CG of the main path written as one scan (``cg_scan``) and
    compiled whole, in host mode under policy="cuda.ell", at NPB-C (K1's
    staged body) and HPCG (K2): what it detects, the launches of the first
    call (counts set to 0 just before it) and by the profiler on a later
    one, the repacks and the detections of the first and the second call,
    the iterate against the per-iteration CG's and the uncompiled scan's,
    and the ms of one solve: the compiled scan, the main path's
    per-iteration CG (baked plans) and the uncompiled scan.  Then
    ``ell_scan`` on NPB-C's ELL in trace mode: the rewritten graph's scan
    and what its body holds, the output against host mode's and the
    uncompiled scan's, and K1's direct-body launches."""
    import torch
    from repro_torch import lilac
    from repro_torch.kernels.spmv_ell import kernel as K
    from repro_torch.sparse import ell_from_csr

    on_card = device.type == "cuda"
    out = {}
    for name, body in SCAN_CASES:
        a, b = mats[name]
        args = (a.val, a.col_ind, a.row_ptr, b)
        fast = lilac.compile(cg_scan, mode="host", policy="cuda.ell",
                             device=device)
        stores = fast.plan_info()["plan_cache_stats"]["stores"]
        calls, restore = _detect_spy()
        try:
            K.reset_launches()
            x = fast(*args)
            sync(device)
            launches = dict(K.LAUNCHES)
            first = {"detects": calls["n"],
                     "repacks": fast.cache.stats.misses}
            fast(*args)
            sync(device)
            second = {"detects": calls["n"] - first["detects"],
                      "repacks": fast.cache.stats.misses - first["repacks"]}
        finally:
            restore()
        report = fast.last_report
        r = {"body": body, "first": first, "second": second,
             "launches": launches[body], "all_launches": launches,
             "matches": [(m.computation, m.variant)
                         for m in report.matches],
             "inner": [[(i.computation, i.variant) for i in m.body[1]]
                       for m in report.matches if m.body is not None],
             "selections": [(m.computation, n)
                            for m, n in fast.last_selections],
             "plan_info": {k: v for k, v in fast.plan_info().items()
                           if k in ("baked", "no_bake", "bake_errors")},
             "persisted": fast.plan_info()["plan_cache_stats"]["stores"]
             - stores}
        x_naive = cg_scan(*args)
        r.update(rel_to_cg=rel_l2(x, x_refs[name]),
                 rel_to_naive_scan=rel_l2(x, x_naive),
                 finite=bool(torch.isfinite(x).all()),
                 shape=tuple(x.shape), rows=a.rows)
        per_iter = lilac.compile(naive_spmv, mode="host", policy="cuda.ell",
                                 device=device)
        prof = profiled_ms(lambda: fast(*args), 1, body + "_kernel") \
            if on_card else {}
        r["profiled_launches"] = prof.get("launches")
        r["device_ms"] = {
            "compiled_scan": prof.get("device_ms"),
            "per_iteration_cg": profiled_ms(
                lambda: cg(per_iter, a, b, iters), 1, body + "_kernel")
            ["device_ms"] if on_card else None}
        r["ms"] = {"compiled_scan": _host_ms(lambda: fast(*args), device,
                                             reps),
                   "per_iteration_cg": _host_ms(
                       lambda: cg(per_iter, a, b, iters), device, reps),
                   "naive_scan": _host_ms(lambda: cg_scan(*args), device,
                                          reps)}
        out[name] = r
        del fast, per_iter, x, x_naive
        release(device)

    # trace mode: the ELL layer's loop, K1's direct body as the custom op
    a = mats["npb"][0]
    ell = ell_from_csr(a, lane=128)
    rng = torch.Generator(device="cpu").manual_seed(seed + 11)
    v0 = torch.randn(a.cols, generator=rng).to(device)
    bias = torch.randn(a.rows, generator=rng).to(device)
    args = (ell.val, ell.col, v0, bias)
    traced = lilac.compile(ell_scan, device=device)
    host = lilac.compile(ell_scan, mode="host", device=device)
    graph = traced.graph_for(*args)
    scans = [n for n in graph.graph.nodes
             if n.target is torch.ops.higher_order.scan]
    body_ops = [str(n.target) for n in getattr(
        graph, scans[0].args[0].target).graph.nodes
        if n.op == "call_function"] if scans else []
    K.reset_launches()
    y = traced(*args)
    sync(device)
    launches = K.LAUNCHES["spmv_ell"]
    step_calls = eager_scan_step_calls(steps)
    y_host = host(*args)
    y_naive = ell_scan(*args)
    err, scaled = max_err(y, y_naive)
    out["trace"] = {
        "scans": len(scans), "custom_op_in_body":
            sum("lilac_torch.spmv_ell" in t for t in body_ops),
        "selections": [(m.computation, n) for m, n in traced.last_selections],
        "host_selections": [(m.computation, n)
                            for m, n in host.last_selections],
        "launches": launches, "step_calls": step_calls,
        "equal_to_host": bool(torch.equal(y, y_host)),
        "max_abs_err": err, "within_tol": scaled <= 1.0,
        "ms": _host_ms(lambda: traced(*args), device, reps)}
    del traced, host, graph, ell
    release(device)
    return out


def check_scan_path(res, iters: int = CG_ITERS,
                    steps: int = SCAN_LAYER_STEPS) -> None:
    calls = iters + 1                   # one SpMV for r0, one per iteration

    def of(ms, comp):
        return [tuple(m) for m in ms if m[0] == comp]

    for name, body in SCAN_CASES:
        r = res[name]
        require(of(r["matches"], "spmv_csr") == [("spmv_csr", "vectorized")]
                and of(r["matches"], "scan_body")
                == [("scan_body", "scan_body")] and len(r["inner"]) == 1
                and of(r["inner"][0], "spmv_csr")
                == [("spmv_csr", "vectorized")],
                f"{name} scan: one top-level spmv_csr match and one "
                f"scan_body holding one more, got {r['matches']} / "
                f"{r['inner']}")
        require([n for c, n in r["selections"] if c == "spmv_csr"]
                == ["cuda.ell"] * 2,
                f"{name} scan: cuda.ell for both SpMVs, got "
                f"{r['selections']}")
        require(r["launches"] == calls,
                f"{name} scan: {body} launched {calls} times a call, got "
                f"{r['launches']}")
        require(r["profiled_launches"] == calls,
                f"{name} scan: {calls} launches of {body} a call by the "
                f"profiler, got {r['profiled_launches']}")
        require(r["first"] == {"detects": 2, "repacks": 1},
                f"{name} scan: 2 detections and 1 repack on the first call, "
                f"got {r['first']}")
        require(r["second"] == {"detects": 0, "repacks": 0},
                f"{name} scan: no detection and no repack on the second "
                f"call, got {r['second']}")
        require(r["plan_info"]["baked"] == 0 and r["plan_info"]["bake_errors"]
                and r["persisted"] == 0,
                f"{name} scan: no plan and no plan-cache record, got "
                f"{r['plan_info']}, {r['persisted']} stores")
        require(r["finite"] and r["shape"] == (r["rows"],),
                f"{name} scan: finite iterate of shape ({r['rows']},)")
        require(r["rel_to_cg"] <= CG_RTOL and r["rel_to_naive_scan"] <= CG_RTOL,
                f"{name} scan: the iterate within {CG_RTOL} of the "
                f"per-iteration CG's and the uncompiled scan's, got "
                f"{r['rel_to_cg']:.3g} and {r['rel_to_naive_scan']:.3g}")
    t = res["trace"]
    require(t["scans"] == 1 and t["custom_op_in_body"] == 1,
            f"ELL scan in trace mode: one scan whose body holds one "
            f"lilac_torch::spmv_ell, got {t['scans']} scans, "
            f"{t['custom_op_in_body']} in the body")
    require([tuple(s) for s in t["selections"]] == [("spmv_ell", "cuda.ell")],
            f"ELL scan: cuda.ell in trace mode, got {t['selections']}")
    require(t["launches"] == t["step_calls"],
            f"ELL scan: K1's direct body launched once each time the eager "
            f"scan calls the step ({t['step_calls']} for {steps} steps), got "
            f"{t['launches']}")
    require(t["equal_to_host"], "ELL scan: trace mode equal to host mode")
    require(t["within_tol"],
            f"ELL scan: within atol={KERNEL_ATOL} + rtol={KERNEL_RTOL}*|ref| "
            f"of the uncompiled scan, max |err| {t['max_abs_err']:.3g}")


def print_scan_path(res, smi: str) -> None:
    for name, body in SCAN_CASES:
        r = res[name]
        print(f"scan {name} (CG as one scan of {CG_ITERS} steps, host mode, "
              f"cuda.ell): matches {r['matches']}, in the scan body "
              f"{r['inner']}; selections {r['selections']}; {body} launched "
              f"{r['launches']} times in the first call (all "
              f"{r['all_launches']}), {r['profiled_launches']} a call by the "
              f"profiler; first call {r['first']}, second {r['second']}; "
              f"|x-x_cg|/|x_cg| = {r['rel_to_cg']:.3g}, |x-x_scan|/|x_scan| "
              f"= {r['rel_to_naive_scan']:.3g} (tol {CG_RTOL}); "
              f"{r['plan_info']}, {r['persisted']} plan-cache stores")
        ms = r["ms"]
        dev = r["device_ms"]
        print(f"scan {name} times ({smi}, host clock from a sync to a sync, "
              f"median a solve): compiled scan {ms['compiled_scan']:.3f} ms "
              f"(its kernels' device time by the profiler, in ms: "
              f"{_ms(dev['compiled_scan'])}), per-iteration CG (main path, "
              f"baked) {ms['per_iteration_cg']:.3f} ms (kernels, in ms: "
              f"{_ms(dev['per_iteration_cg'])}), uncompiled scan "
              f"{ms['naive_scan']:.3f} ms")
    t = res["trace"]
    print(f"scan ELL layer x {SCAN_LAYER_STEPS} (npb, trace mode): "
          f"{t['scans']} scan in the rewritten graph, "
          f"{t['custom_op_in_body']} lilac_torch::spmv_ell in its body, "
          f"selections {t['selections']} (host mode {t['host_selections']});"
          f" K1 direct launches {t['launches']} (torch's eager scan calls "
          f"the step {t['step_calls']} times for {SCAN_LAYER_STEPS} steps); "
          f"equal to host mode "
          f"{t['equal_to_host']}; max|err| against the uncompiled scan "
          f"{t['max_abs_err']:.3g}; {t['ms']:.3f} ms a call ({smi})")


# ---------------------------------------------------------------------------
# torch.func.vmap over lilac.compile: several right-hand sides at once
# ---------------------------------------------------------------------------

VMAP_RHS = 8                   # the right-hand sides of one vmapped solve
VMAP_CASES = (("npb", "spmv_ell_staged"), ("hpcg", "spmv_ell_windowed"))
# each vmapped iterate against its own solo compiled CG: each SpMV is bit
# for bit a solo launch's, but torch's vmap of torch.dot (a bmm) rounds
# apart from torch.dot: 2.6e-5 against 2.0e-7 relative over 1.1 M f32
# terms on the CPU.  So the bound is 1e-5 or twice the uncompiled
# program's own vmapped-against-solo spread on the same right-hand sides,
# the larger
VMAP_SOLO_RTOL = 1e-5


def naive_spmv_oop(val, col, row_ptr, v):
    """``naive_spmv`` written out of place, as a vmapped program must be:
    eager ``torch.func.vmap`` cannot add a batch into an unbatched buffer
    in place (the detector matches both forms)."""
    import torch

    rows = row_ptr.shape[0] - 1
    row = torch.repeat_interleave(torch.arange(rows, device=val.device),
                                  torch.diff(row_ptr), output_size=val.shape[0])
    out = torch.zeros(rows, dtype=val.dtype, device=val.device)
    return out.index_add(0, row, val * v[col])


def rhs_batch(b, k: int, seed: int):
    """``k`` right-hand sides: ``b``, then ``b`` scaled and perturbed."""
    import torch

    gen = torch.Generator(device=b.device).manual_seed(seed + 17)
    noise = torch.rand((k - 1, b.shape[0]), generator=gen, device=b.device)
    scale = torch.arange(2, k + 1, device=b.device, dtype=b.dtype)[:, None]
    return torch.cat([b[None], b[None] * scale / 2 + 0.1 * noise])


def batched_numbers(run, solo, plain, kernel: str, on_card: bool, reps: int,
                    nb: int, flops: int, dtype="torch.float32",
                    atol=KERNEL_ATOL, rtol=KERNEL_RTOL, what=""):
    """One batched launch ``run()`` held against the same batch launched
    element by element (``solo()``, its rows stacked: bit for bit) and
    against its plain version, then timed beside the solo launches, with
    its bound (the matrix's stored entries read once, plus the B vectors
    and the B outputs) and its share of that bound."""
    import torch

    got, each, want = run(), solo(), plain()
    if on_card:
        torch.cuda.synchronize()
    err, scaled = max_err(got, want, atol, rtol)
    require(scaled <= 1.0, f"{what}: batched launch within atol={atol} + "
            f"rtol={rtol}*|ref| of the plain version, max |err| {err:.3g}")
    res = {"equal_to_solo": bool(torch.equal(got, each)), "max_abs_err": err,
           "bytes": nb, "flops": flops}
    del got, each, want
    res["bound_ms"], res["bound_by"] = bound_ms(nb, flops, dtype)
    res["ms"], res["host_ms"] = cuda_ms(run, reps) if on_card else (None,
                                                                    None)
    res["solo_ms"] = cuda_ms(solo, reps)[0] if on_card else None
    res["profiler_ms"] = profiled_ms(run, max(2, reps // 2), kernel)["ms"] \
        if on_card else None
    res["plain_ms"] = cuda_ms(plain, 2)[0] if on_card else None
    res["share"] = res["bound_ms"] / res["ms"] if res["ms"] else None
    return res


def vmap_path(mats, x_refs, seed: int, device, iters: int = CG_ITERS,
              rhs: int = VMAP_RHS, reps: int = 10) -> dict:
    """``torch.func.vmap`` over compiled functions at the main path's
    shapes: the CG of ``rhs`` right-hand sides at NPB-C (K1 staged) and
    HPCG (K2), the naive SpMV compiled in host mode under
    policy="cuda.ell"; the ELL layer in trace mode over ``rhs`` vectors at
    NPB-C (K1 direct, lilac_torch::spmv_ell's vmap rule); the cuda.bcsr
    SpMV over ``rhs`` vectors at HPCG (K3, the vectors as the operand's
    columns).  For each: the launches of the vmapped call (counts set to 0
    just before it; the CGs' second solve, served by the batched plan the
    first call baked), the answer against its solo and uncompiled forms,
    and one batched launch against the solo launches and the plain
    version, timed with its bound."""
    import torch
    from repro_torch import lilac
    from repro_torch.kernels.bsr_spmm import kernel as B
    from repro_torch.kernels.bsr_spmm import ref as BR
    from repro_torch.kernels.spmv_ell import kernel as K
    from repro_torch.kernels.spmv_ell import ref as R
    from repro_torch.sparse import PackedBCSR, WindowedELL, ell_from_csr

    on_card = device.type == "cuda"
    gen = torch.Generator(device=device).manual_seed(seed + 19)
    out = {}
    for name, body in VMAP_CASES:
        a, b = mats[name]
        bs = rhs_batch(b, rhs, seed)
        fast = lilac.compile(naive_spmv_oop, mode="host", policy="cuda.ell",
                             device=device)

        def solve(f=fast, a=a, bs=bs):
            return torch.func.vmap(lambda bb: cg(f, a, bb, iters))(bs)

        xs = solve()                    # bakes the batched plan
        sync(device)
        repacks = [fast.cache.stats.misses]
        hits, detects = fast.plan_info()["plan_hits"], fast.stats["detects"]
        K.reset_launches()
        again = solve()
        sync(device)
        launches = dict(K.LAUNCHES)
        repacks.append(fast.cache.stats.misses - repacks[0])
        info = fast.plan_info()
        batched_plans = [q for q in info["plans"] if q["transform"]]
        prof = profiled_ms(solve, 1, body + "_kernel") if on_card else {}
        r = {"body": body, "launches": launches[body],
             "all_launches": launches, "profiled_launches":
                 prof.get("launches"), "repacks": repacks,
             "plan_hits": info["plan_hits"] - hits,
             "detects": fast.stats["detects"] - detects,
             "equal_to_first_solve": bool(torch.equal(xs, again)),
             "batched_plans": [{k: q[k] for k in (
                 "transform", "runs", "eager_reason", "replay_ms",
                 "eager_ms", "graph_copy_bytes", "recaptures")}
                 for q in batched_plans],
             "breakdown": step_breakdown(solve, device, top=4)
             if on_card else None,
             "selections": [n for _, n in fast.last_selections],
             "matches": [(m.computation, m.format)
                         for m in fast.last_report.matches],
             "shape": tuple(xs.shape), "finite": bool(torch.isfinite(xs)
                                                      .all())}
        # each right-hand side alone through the same compiled function:
        # an unbatched entry, which bakes and then serves its plan
        hits = fast.plan_info()["plan_hits"]
        x_solo = torch.stack([cg(fast, a, bs[j], iters) for j in range(rhs)])
        info = fast.plan_info()
        r.update(bake_errors=info["bake_errors"], baked=info["baked"],
                 solo_plan_hits=info["plan_hits"] - hits,
                 solo_repacks=fast.cache.stats.misses - sum(repacks))
        x_naive = torch.func.vmap(
            lambda bb: cg(naive_spmv_oop, a, bb, iters))(bs)
        x_naive_solo = [cg(naive_spmv_oop, a, bs[j], iters)
                        for j in range(rhs)]
        r["rel_to_solo"] = max(rel_l2(xs[j], x_solo[j]) for j in range(rhs))
        r["rel_to_naive"] = max(rel_l2(xs[j], x_naive[j])
                                for j in range(rhs))
        r["naive_spread"] = max(rel_l2(x_naive[j], x_naive_solo[j])
                                for j in range(rhs))
        r["rel_to_main_path"] = rel_l2(xs[0], x_refs[name])
        # the unplanned route beside it: the same program with bake=False (on
        # the same data plane, so no second repack)
        unplanned = lilac.compile(naive_spmv_oop, mode="host",
                                  policy="cuda.ell", device=device,
                                  bake=False, cache=fast.cache)
        r["unplanned_equal"] = bool(torch.equal(
            xs, solve(f=unplanned)))
        r["ms"] = {"vmapped_solve": _host_ms(solve, device, 3),
                   "unplanned_vmapped_solve": _host_ms(
                       lambda: solve(f=unplanned), device, 3),
                   f"{rhs}_solo_solves": _host_ms(
                       lambda: [cg(fast, a, bs[j], iters)
                                for j in range(rhs)], device, 3)}
        # one batched launch of the body against its rhs solo launches
        (layout,) = marshaled(fast, WindowedELL)
        vecs = torch.randn((rhs, a.cols), generator=gen, device=device)
        wrapper = getattr(K, body + "_cuda")
        kw = dict(perm=layout.perm, out_rows=a.rows)
        csr_t = sparse_csr(a)
        vt = vecs.T.contiguous()
        r["kernel"] = batched_numbers(
            lambda: wrapper(layout, vecs, **kw),
            lambda: torch.stack([wrapper(layout, v, **kw) for v in vecs]),
            lambda: torch.func.vmap(lambda v: R.spmv_ell_windowed_plain(
                layout, v, **kw))(vecs),
            body + "_kernel", on_card, reps,
            # the stored entries once (a value and a 16-bit id), the B
            # vectors, the permutation, the B outputs
            a.nnz * (layout.val.element_size() + layout.col.element_size())
            + nbytes(vecs, layout.perm) + rhs * a.rows * 4,
            2 * a.nnz * rhs, what=f"vmap {body}")
        r["kernel"]["library_ms"] = cuda_ms(lambda: csr_t @ vt, reps)[0] \
            if on_card else None
        out[name] = r
        del fast, unplanned, xs, again, x_solo, x_naive, x_naive_solo
        del layout, csr_t, vt
        release(device)

    # trace mode: the ELL layer over rhs vectors, K1's direct body
    a = mats["npb"][0]
    ell = ell_from_csr(a, lane=128)
    vecs = torch.randn((rhs, a.cols), generator=gen, device=device)
    bias = torch.randn(a.rows, generator=gen, device=device)
    traced = lilac.compile(ell_layer, device=device)
    host = lilac.compile(ell_layer, mode="host", device=device)

    def layer(f):
        return torch.func.vmap(lambda v: f(ell.val, ell.col, v, bias))(vecs)

    K.reset_launches()
    y = layer(traced)
    sync(device)
    first = K.LAUNCHES["spmv_ell"]
    K.reset_launches()
    y2 = layer(traced)
    sync(device)
    second = K.LAUNCHES["spmv_ell"]
    y_host = layer(host)
    y_plain = layer(ell_layer)
    err, scaled = max_err(y, y_plain)
    kw = dict(bias=bias, epilogue="relu")
    out["trace"] = {
        "launches": [first, second],
        "selections": [(m.computation, n) for m, n in traced.last_selections],
        "host_selections": [(m.computation, n)
                            for m, n in host.last_selections],
        "equal_to_host": bool(torch.equal(y, y_host)),
        "max_abs_err": err, "within_tol": scaled <= 1.0,
        "plan_equal": bool(torch.equal(y, y2)),
        "plan_info": {k: traced.plan_info()[k]
                      for k in ("baked", "plan_hits", "bake_errors")},
        "ms": _host_ms(lambda: layer(traced), device, 3)}
    csr_t = sparse_csr(a)
    vt = vecs.T.contiguous()
    out["trace"]["kernel"] = batched_numbers(
        lambda: K.spmv_ell_cuda(ell.val, ell.col, vecs, **kw),
        lambda: torch.stack([K.spmv_ell_cuda(ell.val, ell.col, v, **kw)
                             for v in vecs]),
        lambda: torch.func.vmap(lambda v: R.spmv_ell_plain(
            ell.val, ell.col, v, **kw))(vecs),
        "spmv_ell_kernel", on_card, reps,
        a.nnz * (ell.val.element_size() + ell.col.element_size())
        + nbytes(vecs, bias) + rhs * a.rows * 4, 2 * a.nnz * rhs,
        what="vmap spmv_ell")
    out["trace"]["kernel"]["library_ms"] = cuda_ms(
        lambda: csr_t @ vt, reps)[0] if on_card else None
    del traced, host, ell, csr_t, vt, y, y2, y_host, y_plain
    release(device)

    # K3: the cuda.bcsr SpMV over rhs vectors, the operand's columns
    a = mats["hpcg"][0]
    vecs = torch.randn((rhs, a.cols), generator=gen, device=device)
    fast = lilac.compile(naive_spmv_oop, mode="host", policy="cuda.bcsr",
                         device=device)
    B.reset_launches()
    y = torch.func.vmap(lambda v: fast(a.val, a.col_ind, a.row_ptr, v))(vecs)
    sync(device)
    launches = dict(B.LAUNCHES)
    B.reset_launches()
    y2 = torch.func.vmap(lambda v: fast(a.val, a.col_ind, a.row_ptr, v))(
        vecs)
    sync(device)
    plan_launches = dict(B.LAUNCHES)
    (packed,) = marshaled(fast, PackedBCSR)
    vt = vecs.T.contiguous()
    cols = [vt[:, j:j + 1].contiguous() for j in range(rhs)]
    plain = BR.bsr_spmm_plain(packed, vt, out_rows=a.rows).T
    err, scaled = max_err(y, plain)
    csr_t = sparse_csr(a)
    out["bcsr"] = {
        "launches": launches, "selections": [n for _, n in
                                             fast.last_selections],
        "plan_launches": plan_launches, "plan_equal": bool(torch.equal(y, y2)),
        "plan_info": {k: fast.plan_info()[k]
                      for k in ("baked", "plan_hits", "bake_errors")},
        "max_abs_err": err, "within_tol": scaled <= 1.0,
        "rel_to_naive": rel_l2(y, torch.func.vmap(lambda v: naive_spmv_oop(
            a.val, a.col_ind, a.row_ptr, v))(vecs)),
        "kernel": batched_numbers(
            lambda: B.bsr_spmm_cuda(packed, vt, out_rows=a.rows),
            lambda: torch.cat([B.bsr_spmm_cuda(packed, c, out_rows=a.rows)
                               for c in cols], 1),
            lambda: BR.bsr_spmm_plain(packed, vt, out_rows=a.rows),
            "bsr_spmm_narrow", on_card, reps,
            packed.nnz * (packed.val.element_size() + 2) + nbytes(vt)
            + rhs * a.rows * 4, 2 * packed.nnz * rhs, what="vmap bsr_spmm")}
    out["bcsr"]["kernel"]["library_ms"] = cuda_ms(
        lambda: csr_t @ vt, reps)[0] if on_card else None
    del fast, packed, csr_t, vt, cols, y, y2, plain
    release(device)
    return out


def check_vmap_path(res, iters: int = CG_ITERS) -> None:
    calls = iters + 1                   # one SpMV for r0, one per iteration
    for name, body in VMAP_CASES:
        r = res[name]
        require([tuple(m) for m in r["matches"]] == [("spmv_csr", "CSR")]
                and r["selections"] == ["cuda.ell"],
                f"vmap {name}: one spmv_csr/CSR match on cuda.ell, got "
                f"{r['matches']} via {r['selections']}")
        require(r["launches"] == calls and r["profiled_launches"] == calls,
                f"vmap {name}: {body} launched once a batched SpMV ({calls} "
                f"a solve), got {r['launches']} (profiler "
                f"{r['profiled_launches']})")
        require(r["repacks"] == [1, 0] and r["solo_repacks"] == 0,
                f"vmap {name}: one repack, then none (solo calls too), got "
                f"{r['repacks']}, {r['solo_repacks']}")
        require(r["plan_hits"] == calls and r["detects"] == 0
                and r["equal_to_first_solve"] and r["unplanned_equal"]
                and len(r["batched_plans"]) == 1,
                f"vmap {name}: the second vmapped solve is {calls} of "
                f"{calls} plan hits with no detection, bit for bit the "
                f"first solve's and the unplanned solve's, got "
                f"{r['plan_hits']} hits, {r['detects']} detections, equal "
                f"{r['equal_to_first_solve']} / {r['unplanned_equal']}, "
                f"batched plans {r['batched_plans']}")
        require(r["baked"] == 2 and not r["bake_errors"],
                f"vmap {name}: the vmapped entry and the solo one each bake "
                f"a plan, got baked {r['baked']}, bake_errors "
                f"{r['bake_errors']}")
        require(r["solo_plan_hits"] > 0,
                f"vmap {name}: solo calls afterwards hit their plan, got "
                f"{r['solo_plan_hits']} hits")
        solo_tol = max(VMAP_SOLO_RTOL, 2 * r["naive_spread"])
        require(r["finite"] and r["rel_to_solo"] <= solo_tol
                and r["rel_to_naive"] <= CG_RTOL,
                f"vmap {name}: each iterate within {solo_tol:.3g} of its "
                f"solo compiled CG (the uncompiled CG's own vmapped-solo "
                f"spread {r['naive_spread']:.3g}) and within {CG_RTOL} of "
                f"the vmapped uncompiled CG, got {r['rel_to_solo']:.3g} and "
                f"{r['rel_to_naive']:.3g}")
        require(r["kernel"]["equal_to_solo"],
                f"vmap {name}: one batched {body} launch equal bit for bit "
                f"to its {VMAP_RHS} solo launches")
    t = res["trace"]
    require(t["plan_equal"] and t["plan_info"]["baked"] == 1
            and t["plan_info"]["plan_hits"] >= 1
            and not t["plan_info"]["bake_errors"],
            f"vmap ELL layer (trace mode): the second call a hit on the "
            f"batched plan, equal to the first bit for bit, got "
            f"{t['plan_info']}, equal {t['plan_equal']}")
    require(t["launches"] == [1, 1] and t["equal_to_host"]
            and t["within_tol"]
            and [tuple(s) for s in t["selections"] + t["host_selections"]]
            == [("spmv_ell", "cuda.ell")] * 2,
            f"vmap ELL layer (trace mode): one K1 direct launch a call, equal "
            f"to host mode, within tolerance of the uncompiled layer, got "
            f"{t['launches']} launches, selections {t['selections']}, "
            f"equal {t['equal_to_host']}")
    require(t["kernel"]["equal_to_solo"],
            "vmap ELL layer: one batched K1 direct launch equal bit for bit "
            "to its solo launches")
    k3 = res["bcsr"]
    require(k3["plan_launches"] == k3["launches"] and k3["plan_equal"]
            and k3["plan_info"]["plan_hits"] == 1
            and not k3["plan_info"]["bake_errors"],
            f"vmap cuda.bcsr: the second call a hit on the batched plan, one "
            f"K3 narrow launch, equal to the first bit for bit, got "
            f"{k3['plan_info']}, {k3['plan_launches']}, equal "
            f"{k3['plan_equal']}")
    require(k3["launches"] == {"bsr_spmm_wide": 0, "bsr_spmm_narrow": 1}
            and k3["selections"] == ["cuda.bcsr"] and k3["within_tol"],
            f"vmap cuda.bcsr: one K3 (narrow) launch for {VMAP_RHS} vectors "
            f"within tolerance of the plain version, got {k3['launches']}, "
            f"{k3['selections']}, max |err| {k3['max_abs_err']:.3g}")


def print_vmap_path(res, smi: str) -> None:
    def kernel_line(k) -> str:
        share = f"{k['share']:.3f}" if k["share"] is not None else "n/a"
        return (f"one launch at B = {VMAP_RHS}: {_ms(k['ms'])} ms (profiler "
                f"{_ms(k['profiler_ms'])} ms a launch, host "
                f"{_ms(k['host_ms'])} ms to enqueue), {VMAP_RHS} solo "
                f"launches {_ms(k['solo_ms'])} ms, bound "
                f"{k['bound_ms']:.4f} ms by {k['bound_by']} (share {share}), "
                f"plain {_ms(k['plain_ms'])} ms, cuSPARSE SpMM "
                f"{_ms(k['library_ms'])} ms; equal to the solo launches bit "
                f"for bit: {k['equal_to_solo']}; max|err| vs plain "
                f"{k['max_abs_err']:.3g} ({smi})")

    for name, body in VMAP_CASES:
        r = res[name]
        print(f"vmap {name} CG x {VMAP_RHS} right-hand sides (host mode, "
              f"cuda.ell): {body} launched {r['launches']} times a solve "
              f"(profiler {r['profiled_launches']}; all {r['all_launches']})"
              f"; repacks {r['repacks']}; selections {r['selections']}; "
              f"iterates against their solo compiled CGs "
              f"{r['rel_to_solo']:.3g} (tol max({VMAP_SOLO_RTOL}, twice the "
              f"uncompiled CG's vmapped-solo spread {r['naive_spread']:.3g}))"
              f", against the "
              f"vmapped uncompiled CG {r['rel_to_naive']:.3g} (tol "
              f"{CG_RTOL}), the first against the main path's naive CG "
              f"{r['rel_to_main_path']:.3g}; the second solve "
              f"{r['plan_hits']} plan hits, {r['detects']} detections, "
              f"equal to the first {r['equal_to_first_solve']} and to the "
              f"unplanned solve {r['unplanned_equal']}; batched plan "
              f"{r['batched_plans']}; baked {r['baked']}, bake_errors "
              f"{r['bake_errors']}; solo calls after it: "
              f"{r['solo_plan_hits']} plan hits")
        print(f"vmap {name} times ({smi}, host clock from a sync to a sync, "
              f"median of 3): one vmapped solve on plans "
              f"{r['ms']['vmapped_solve']:.3f} ms, unplanned (bake=False) "
              f"{r['ms']['unplanned_vmapped_solve']:.3f} ms, {VMAP_RHS} solo "
              f"solves (baked plans) "
              f"{r['ms'][f'{VMAP_RHS}_solo_solves']:.3f} ms; one vmapped "
              f"solve on plans profiled: {r['breakdown']}")
        print(f"vmap {body} ({name}): {kernel_line(r['kernel'])}")
    t = res["trace"]
    print(f"vmap ELL layer x {VMAP_RHS} vectors (npb, trace mode): K1 direct "
          f"launches a call {t['launches']}, selections {t['selections']} "
          f"(host mode {t['host_selections']}), equal to host mode "
          f"{t['equal_to_host']}, max|err| against the uncompiled layer "
          f"{t['max_abs_err']:.3g}, {t['ms']:.3f} ms a call on its plan; "
          f"plan {t['plan_info']}, the plan's call equal to the first "
          f"{t['plan_equal']}")
    print(f"vmap spmv_ell (npb ELL, relu+bias): {kernel_line(t['kernel'])}")
    k3 = res["bcsr"]
    print(f"vmap cuda.bcsr SpMV x {VMAP_RHS} vectors (hpcg): launches "
          f"{k3['launches']} (on the plan {k3['plan_launches']}), selections "
          f"{k3['selections']}, max|err| vs plain {k3['max_abs_err']:.3g}, "
          f"|y-y_naive|/|y_naive| {k3['rel_to_naive']:.3g}; plan "
          f"{k3['plan_info']}, equal to the first call {k3['plan_equal']}")
    print(f"vmap bsr_spmm_narrow (hpcg, the vectors as {VMAP_RHS} columns):"
          f" {kernel_line(k3['kernel'])}")


def vmap_entries(res) -> list:
    """The kernels line's entries of the vmap phase: each body's batched
    launch, with the launches of the vmapped call."""
    def entry(name, path, launches, k):
        return {"name": name, "path": path, "route": "cuda",
                "source": SOURCES[name], "replaces": REPLACES[name],
                "launches": launches, "max_abs_err": k["max_abs_err"],
                "ms": k["ms"], "plain_ms": k["plain_ms"],
                "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                "library_ms": k["library_ms"]}

    out = [entry(body, f"vmap: the {name} CG over {VMAP_RHS} right-hand "
                       f"sides (one launch for the {VMAP_RHS})",
                 res[name]["launches"], res[name]["kernel"])
           for name, body in VMAP_CASES]
    out.append(entry("spmv_ell", f"vmap: the ELL layer over {VMAP_RHS} "
                                 f"vectors in trace mode",
                     res["trace"]["launches"][0], res["trace"]["kernel"]))
    out.append(entry("bsr_spmm_narrow", f"vmap: the cuda.bcsr SpMV over "
                                        f"{VMAP_RHS} vectors as columns",
                     res["bcsr"]["launches"]["bsr_spmm_narrow"],
                     res["bcsr"]["kernel"]))
    return out


# ---------------------------------------------------------------------------
# Serving: OLMoE-1B-7B at full width through repro_torch.serve
# ---------------------------------------------------------------------------

SERVE_BATCH, SERVE_SEQ = (1, 8), (256, 512)
SERVE_REQUESTS = 8
# the teacher-forced comparisons' decode steps (at most; a stream's own
# length bounds them)
SERVE_TEACHER_STEPS = 16
SERVE_PROMPTS, SERVE_NEW = (32, 200), (16, 64)
# the prompt lengths OLMoE's serving phase draws (the workload's prompt
# grid): its engine compiles its prefill at each (jit_prefill) in its
# prewarm, so no compile lands on the request path; the phases whose
# prefill runs eagerly draw lengths across SERVE_PROMPTS
SERVE_PROMPT_GRID = (64, 200)
# the served engine's entries compile with aot_eager here: inductor took
# 151-183 s for each length's full-depth prefill and 12-31 s for each
# install and move graph (an NVIDIA H100 80GB HBM3 at 700 W), 565 s of
# prewarm that the script's time limit cannot hold.  The engine's default
# (inductor) compiles the prefill at one length of the burst apart
# (``inductor_prefill``), on OLMoE-1B-7B at full width with its depth cut
# to SERVE_INDUCTOR_LAYERS (at 16 layers its compile took 231.7 s, on
# the same card), held against the eager prefill and the f32 oracle: its
# logits' distance from the eager ones within SERVE_PREFILL_FACTOR times
# the eager prefill's own distance from the f32 oracle, and at least the
# bf16 limit SERVE_LOGIT_RTOL (two bf16 roundings of one function, each
# about as far from the exact one as the eager rounding; at 16 layers
# the three logits lay 0.25-0.89 apart); cut to 1 layer from 2 (57.1 s of
# compile there) for the script's time limit
SERVE_BACKEND = "aot_eager"
SERVE_INDUCTOR_LAYERS = 1
# the served OLMoE's depth, cut from 16: the distributed phase's recurrent
# mixers (~180 s) took the script to 1,028.1 s at 16, 1,069.4 s at 8 and
# 1,170.3 s at 4 on a slower host (the same card)
SERVE_LAYERS = 2
SERVE_PREFILL_FACTOR = 2.0
# the fault runs: one batch of requests that all end on the same step and
# fit the smallest seq bucket, so every step, with a fault or without,
# runs at (8, 256) and a survivor's row sees the shapes it sees unfaulted
SERVE_FAULT_REQUESTS, SERVE_FAULT_NEW = 8, 24
SERVE_FAULT_P = 0.1
# each MoE layer of a compiled bf16 decode step (K4) against the naive
# dense dispatch on the same input: the MoE layer's tolerance (MOE_RTOL);
# the compiled f32 decode against the uncompiled one: f32's (PERF.md §2)
SERVE_LOGIT_RTOL = MOE_RTOL
SERVE_F32_RTOL = 1e-4
SERVE_RAGGED = (1, 7, 33, 200)
# granite-moe-3b-a800m's depth in its serving phase, cut from 32 for the
# script's time limit (the compiled entry points' compiles, then the
# recurrent mixers on the mesh, took its room)
GRANITE_SERVE_LAYERS = 2


def serve_requests(cfg, seed: int, n: int = SERVE_REQUESTS,
                   prompt=SERVE_PROMPTS, new=SERVE_NEW, grid=()):
    """A closed burst of the SyntheticWorkload (fresh Request objects),
    its prompt lengths drawn from ``grid`` within ``prompt`` (no grid:
    across ``prompt``)."""
    from repro_torch.serve import SyntheticWorkload

    grid = tuple(L for L in grid if prompt[0] <= L <= prompt[1])
    return [r for _, r in SyntheticWorkload(
        n_requests=n, vocab=cfg.vocab, prompt_len=prompt, new_tokens=new,
        seed=seed, prompt_grid=grid).requests()]


def serve_seed(cfg, seed: int, policy, n: int = SERVE_REQUESTS,
               grid=()) -> int:
    """The first workload seed from ``seed`` on (in steps of 1,000) whose
    burst needs both seq buckets and ends in the smaller: a request needs
    more than the first seq bucket's positions, and those with the most
    new tokens (the last to finish, alone in the batch) fit it."""
    def fits(reqs):
        last = max(r.max_new_tokens for r in reqs)
        need = [r.prompt_len + r.max_new_tokens for r in reqs]
        return (max(need) > policy.seq[0]
                and all(r.prompt_len + r.max_new_tokens <= policy.seq[0]
                        for r in reqs if r.max_new_tokens == last))

    s = seed
    while not fits(serve_requests(cfg, s, n, grid=grid)):
        s += 1000
    return s


def fault_requests(cfg, seed: int, policy, replicas: int = 2,
                   n: int = SERVE_FAULT_REQUESTS):
    """``n`` requests of SERVE_FAULT_NEW tokens within the smallest seq
    bucket, with rids that a ``replicas``-way FrontDoor routes evenly (so
    each replica batches at least two, at the largest batch bucket)."""
    from repro_torch.serve import FrontDoor, Request

    hi = min(SERVE_PROMPTS[1], policy.seq[0] - SERVE_FAULT_NEW)
    base = serve_requests(cfg, seed + 29, n, (SERVE_PROMPTS[0], hi),
                          (SERVE_FAULT_NEW, SERVE_FAULT_NEW),
                          SERVE_PROMPT_GRID)
    rids, want = [], {k: n // replicas for k in range(replicas)}
    rid = 10_000_000 + 1000 * seed
    while len(rids) < n:
        rid += 1
        k = FrontDoor._hash(rid) % replicas
        if want[k] > 0:
            want[k] -= 1
            rids.append(rid)
    return [Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                    rid=i) for r, i in zip(base, rids)]


def _step_inputs(reqs, B: int, t: int, device):
    """(tokens, pos) of decode step ``t`` of each request's stream (row
    i = reqs[i]), teacher-forced: the token its stream holds at t."""
    import numpy as np
    import torch

    tok, pos = np.zeros((B, 1), np.int32), np.zeros((B,), np.int32)
    for i, r in enumerate(reqs):
        tok[i, 0], pos[i] = r.tokens[t], r.prompt_len + t
    return (torch.from_numpy(tok).to(device),
            torch.from_numpy(pos).to(device))


def _install(model, params, reqs, shape, device):
    """A (B, S) cache with each request's prefill in its row, and whether
    each prefill's greedy token is the stream's first."""
    import torch

    cache = model.init_cache(*shape, device=device)
    firsts = []
    for i, r in enumerate(reqs):
        logits, caches = model.prefill(params, {"tokens": torch.as_tensor(
            r.prompt[None], device=device)})
        firsts.append(int(logits[0].argmax()) == r.tokens[0])
        model.cache_set_slot(cache, i, model.cache_from_prefill(
            caches, r.prompt_len, shape[1]))
    return cache, firsts


def teacher_steps(reqs) -> int:
    """The teacher-forced decode steps of ``reqs``' streams: as many as
    the shortest stream holds, at most SERVE_TEACHER_STEPS."""
    return min(SERVE_TEACHER_STEPS, min(len(r.tokens) for r in reqs) - 1)


def _teacher_run(dec_c, dec_u, m, p, reqs, shape, device, record=False):
    """``dec_c`` and ``dec_u`` fed the same tokens, the streams of ``reqs``
    from the same prefills in rows 0.. of a ``shape`` cache, each carrying
    its own cache: per step the largest relative L2 error of an active
    row's logits and each step's ms (host clock to a sync); the logits;
    with ``record`` the first MoE layer's router input at the first step
    of ``dec_u``."""
    from repro_torch.models import layers as L
    from repro_torch.models.spec import tree_map

    steps = teacher_steps(reqs)
    n = len(reqs)
    cache_c, firsts = _install(m, p, reqs, shape, device)
    cache_u = tree_map(lambda a: a.clone(), cache_c)
    router, inputs = L.moe_router, []

    def recording(pp, x, topk):
        inputs.append(x.detach())
        return router(pp, x, topk)

    rel, ms_c, ms_u, logits = [], [], [], []
    for t in range(steps):
        tok, pos = _step_inputs(reqs, shape[0], t, device)
        s0 = time.perf_counter()
        lc, cache_c = dec_c(p, cache_c, tok, pos)
        sync(device)
        s1 = time.perf_counter()
        L.moe_router = recording if record and t == 0 else router
        try:
            lu, cache_u = dec_u(p, cache_u, tok, pos)
        finally:
            L.moe_router = router
        sync(device)
        ms_c.append(1e3 * (s1 - s0))
        ms_u.append(1e3 * (time.perf_counter() - s1))
        rel.append(max(rel_l2(lc[i], lu[i]) for i in range(n)))
        logits.append((lc[:n].float(), lu[:n].float()))
    return {"first_token_agrees": firsts, "rel_l2": rel,
            "max_rel_l2": max(rel), "ms_compiled": ms_c,
            "ms_uncompiled": ms_u}, logits, inputs


def compiled_f32(model, params, reqs, shape, device) -> dict:
    """An f32 copy of ``model`` (``params`` already f32) compiled on its
    own (K4's f32 body) against its uncompiled naive decode, teacher-forced
    on the streams of ``reqs`` at ``shape`` (``_teacher_run``), with the
    compiled decode's selections and launches."""
    import torch
    from repro_torch import lilac
    from repro_torch.kernels.common import COUNTERS
    from repro_torch.models import build_model

    m32 = build_model(model.cfg.replace(param_dtype=torch.float32,
                                        cache_dtype=torch.float32))
    fast32 = lilac.compile(m32.decode, mode="host", device=device,
                           plan_cache="off")
    for c in COUNTERS:
        c.update(dict.fromkeys(c, 0))
    res, logits, _ = _teacher_run(fast32, m32.decode, m32, params, reqs,
                                  shape, device)
    res["launches"] = {k: v for c in COUNTERS for k, v in c.items() if v}
    res["selections"] = sorted({n for _, n in fast32.last_selections})
    return res, logits


def teacher_forced(eng, model, params, reqs, device, f32: bool = True
                   ) -> dict:
    """The compiled decode (the engine's baked plans) and the uncompiled
    one fed the same tokens, the batched streams of ``reqs``, from the
    same prefills in rows 0.. of a cache at the engine's bucket
    (``_teacher_run``), and the first MoE layer's router input at the
    first step (for K4's timing).  The same against the uncompiled decode
    whose dense dispatch is computed by cuda.gmm's function
    (``same_moe``: the plans' own arithmetic), and with ``f32`` in f32
    (the parameters cast, a compiled decode of their own: K4's f32 body
    against the naive f32 dispatch) and each bf16 decode's logits against
    the uncompiled f32 decode's, the oracle (a model too large to hold in
    f32 beside its bf16 copy runs its f32 comparison apart)."""
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.models import layers as L
    from repro_torch.models.spec import tree_map

    shape = (eng.buckets.batch_bucket(len(reqs)), eng.buckets.seq_bucket(
        max(r.prompt_len + r.max_new_tokens for r in reqs)))
    steps = teacher_steps(reqs)
    n = len(reqs)

    def run(dec_c, dec_u, m, p, record=False):
        return _teacher_run(dec_c, dec_u, m, p, reqs, shape, device, record)

    res, bf16, inputs = run(eng._decode, model.decode, model, params,
                            record=True)

    def decode_k4(p, cache, tok, pos):
        """The uncompiled decode with its dense dispatch computed by the
        function the cuda.gmm harness computes (K4, bf16)."""
        naive = L._moe_naive_2d
        L._moe_naive_2d = gmm_ops.moe_ffn
        try:
            return model.decode(p, cache, tok, pos)
        finally:
            L._moe_naive_2d = naive

    res["same_moe"], _, _ = run(eng._decode, decode_k4, model, params)
    res.update(shape=shape, steps=steps, router_input=inputs[0])
    if f32:
        p32 = tree_map(lambda a: a.float(), params)
        res["f32"], oracle = compiled_f32(model, p32, reqs, shape, device)
        del p32
        res["bf16_to_f32"] = {
            k: [max(rel_l2(b[j][i], o[1][i]) for i in range(n))
                for b, o in zip(bf16, oracle)]
            for j, k in enumerate(("compiled", "uncompiled"))}
    return res


def moe_f32_oracle(x, gate, idx, wg, wu, wd):
    """The dense dispatch on the same inputs in f32, one expert at a time
    (a Jamba layer's three expert stacks in f32 are 11.3 GB)."""
    import torch
    from repro_torch.core.harness import one_hot

    x = x.float()
    combine = torch.einsum("tke,tk->te", one_hot(idx, wg.shape[0]).float(),
                           gate.float())
    out = torch.zeros((x.shape[0], wd.shape[2]), dtype=torch.float32,
                      device=x.device)
    for e in range(wg.shape[0]):
        h = torch.nn.functional.silu(x @ wg[e].float()) * (x @ wu[e].float())
        out += combine[:, e:e + 1] * (h @ wd[e].float())
    return out


def moe_layers(eng, model, params, reqs, device) -> dict:
    """Each MoE layer of one compiled bf16 decode step against the naive
    dense dispatch on the layer's own input.  The engine's baked plan at
    the bucket of ``reqs`` runs its program once more eagerly with every
    harness call recorded (its binding: the layer's input, routes and
    weights; its output): each layer's output against
    ``layers._moe_naive_2d`` on that binding, in bf16 and against the
    f32 oracle, and the program's logits against the CUDA graph's replay
    on the same inputs (that the recorded program is what the graph
    runs).  Teacher-forced step 0, from the same prefills as
    ``teacher_forced``."""
    import torch
    from torch.utils._pytree import tree_flatten, tree_unflatten
    from repro_torch.core import rewrite
    from repro_torch.models import layers as L

    shape = (eng.buckets.batch_bucket(len(reqs)), eng.buckets.seq_bucket(
        max(r.prompt_len + r.max_new_tokens for r in reqs)))
    cache, _ = _install(model, params, reqs, shape, device)
    tok, pos = _step_inputs(reqs, shape[0], 0, device)
    args = (params, cache, tok, pos)
    plan = eng._decode.executable_plan(*args)
    flat, spec = tree_flatten((args, {}))
    got = plan.match(spec, flat) if plan is not None else None
    if got is None:
        return {"shape": shape, "plan": False}
    tensors, _ = got
    calls, call = [], rewrite.call_harness

    def recording(h, binding, ctx, epilogue):
        out = call(h, binding, ctx, epilogue)
        calls.append((h.name, binding, out))
        return out

    rewrite.call_harness = recording
    try:
        program = tree_unflatten(list(plan.runner(*tensors)), plan.out_spec)
    finally:
        rewrite.call_harness = call
    replay, _ = eng._decode(*args)
    rel, to32 = [], []
    for _, b, out in calls:
        w = [b[k] for k in ("x", "gate", "idx", "wg", "wu", "wd")]
        naive = L._moe_naive_2d(*w)
        oracle = moe_f32_oracle(*w)
        rel.append(rel_l2(out, naive))
        to32.append((rel_l2(out, oracle), rel_l2(naive, oracle)))
    return {"shape": shape, "plan": True,
            "harnesses": [n for n, _, _ in calls], "rel_l2": rel,
            "max_rel_l2": max(rel, default=float("inf")),
            "to_f32": to32,
            "replay_rel_l2": rel_l2(replay[:len(reqs)],
                                    program[0][:len(reqs)])}


def parting_op(model, params, req, solo_shape, device) -> dict:
    """Where a batched stream and its solo run part: the uncompiled decode
    teacher-forced with the stream's tokens, once at the buckets the
    request ran at in the batch (row 0) and once at ``solo_shape``; the
    first step whose logits differ bit for bit, and there the first
    operator (in execution order) whose row-0 output differs bit for bit
    among those whose row has the same shape in both runs."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpLog(TorchDispatchMode):
        def __init__(self, B):
            super().__init__()
            self.B, self.rows = B, []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            row = row0(out, self.B) if isinstance(out, torch.Tensor) \
                and out.dim() >= 1 else None
            # every operator logs, so the two runs' logs stay aligned
            self.rows.append((str(func), None if row is None
                              else row.clone()))
            return out

    def row0(out, B):
        """The first request's part of an operator's output: row 0 of a
        leading batch axis, or of the second axis under a unit one (a
        batched product's); None for an output with no batch axis (a
        weight's slice, the same in both runs)."""
        if out.shape[0] == B:
            return out[:1]
        if out.dim() > 1 and out.shape[0] == 1 and out.shape[1] == B:
            return out[:, :1]
        return None

    shapes = list(req.decode_buckets)
    ca, _ = _install(model, params, [req], shapes[0], device)
    cb, _ = _install(model, params, [req], solo_shape, device)
    shape_a = shapes[0]
    for t in range(len(req.tokens) - 1):
        if shapes[t] != shape_a:
            shape_a = shapes[t]
            ca = model.cache_resize(ca, B=shape_a[0], max_seq=shape_a[1])
        ta, pa = _step_inputs([req], shape_a[0], t, device)
        tb, pb = _step_inputs([req], solo_shape[0], t, device)
        la, ca_next = model.decode(params, ca, ta, pa)
        lb, cb_next = model.decode(params, cb, tb, pb)
        if not torch.equal(la[0], lb[0]):
            logs = []
            for c, tok, pos in ((ca, ta, pa), (cb, tb, pb)):
                with OpLog(tok.shape[0]) as log:
                    model.decode(params, c, tok, pos)
                logs.append(log.rows)
            # the same code at two shapes may dispatch a few other
            # operators (an einsum over a unit axis): align the logs by
            # their operator names
            pairs = [(logs[0][a + k], logs[1][b + k]) for a, b, size in
                     difflib.SequenceMatcher(
                         None, [f for f, _ in logs[0]],
                         [f for f, _ in logs[1]],
                         autojunk=False).get_matching_blocks()
                     for k in range(size)]
            compared, op = 0, None
            for (fa, ra), (fb, rb) in pairs:
                if ra is None or rb is None or ra.shape != rb.shape:
                    continue
                compared += 1
                if not torch.equal(ra, rb):
                    op = {"index": compared, "op": fa,
                          "shape": list(ra.shape),
                          "max_abs_diff": float((ra.float() - rb.float())
                                                .abs().max())}
                    break
            return {"rid": req.rid, "step": t, "batched_shape": shape_a,
                    "solo_shape": solo_shape, "op": op,
                    "ops_compared": compared,
                    "logits_max_abs_diff": float((la[0] - lb[0]).abs().max()),
                    "same_argmax": int(la[0].argmax()) == int(lb[0].argmax())}
        ca, cb = ca_next, cb_next
    return {"rid": req.rid, "step": None}


def _k_leaf(model, params) -> int:
    """The position of the first attention ``k`` cache leaf among the
    decode step's tensor leaves (params..., cache..., tokens, pos): its
    (B, S) is the bucket."""
    from torch.utils._pytree import tree_flatten, tree_flatten_with_path

    cache = model.init_cache(1, 1, device="meta")
    names = [str(path[-1]) for path, _ in tree_flatten_with_path(cache)[0]]
    return len(tree_flatten(params)[0]) + next(
        i for i, n in enumerate(names) if "'k'" in n)


def _plan_rows(fn, k_leaf: int) -> list:
    """Per baked decode plan: its bucket (the (B, S) of tensor leaf
    ``k_leaf``, an attention layer's k cache), CUDA graph or eager, the
    bytes a replay copies, captures, times, hits."""
    out = []
    for p in fn.plan_info()["plans"]:
        b, s = p["tensor_leaves"][k_leaf][0][:2]
        out.append({"bucket": [b, s], "cuda_graph": p["cuda_graph"],
                    "graph_copy_bytes": p["graph_copy_bytes"],
                    "recaptures": p["recaptures"], "replay_ms": p["replay_ms"],
                    "eager_ms": p["eager_ms"], "hits": p["hits"],
                    "selections": sorted(set(p["selections"])),
                    "moe_matches": len(p["selections"])})
    return sorted(out, key=lambda r: r["bucket"])


def cache_bytes(model, shape) -> int:
    """Bytes of a (B, S) decode cache."""
    from repro_torch.models.spec import leaves

    return sum(a.numel() * a.element_size() for _, a in leaves(
        model.init_cache(*shape, device="meta")))


def gmm_decode_phases(cfg, p0, routes: dict, device, reps: int = 20,
                      products=("gate_up",), label: str = "") -> list:
    """K4 (bf16) at the decode step's shapes: T tokens x top-K rows routed
    into the static Tp = ceil(T·K/tm)·tm + (E-1)·tm rows, at T = 1 and
    T = 8, on the routes of each of ``routes`` (name -> router input
    (T', D), T' >= 8), for each of ``products``: ``gate_up`` (the routed
    rows of x times wg) and ``down`` (the rows of silu(x·wg)·(x·wu),
    computed by the plain version, times wd).  Bound: the touched experts'
    weights once, the routed rows in and out; library: torch._grouped_mm
    over the same aligned rows.  Each variant also names ``_route``'s row
    tiles: those that hold routed rows (an expert's rows rounded up to
    ``tm``) and the tail of the static Tp, which K4 computes on expert
    E-1."""
    import torch
    from repro_torch.kernels.moe_gmm import kernel as G
    from repro_torch.kernels.moe_gmm import ref as GR
    from repro_torch.kernels.moe_gmm.ops import _route
    from repro_torch.models import layers as L

    on_card = device.type == "cuda"
    E, D, F = p0["wg"].shape
    K, tm = cfg.moe_topk, 128
    entries = []
    for T in (1, 8):
        for prod in products:
            e = {"name": "gmm", "path": f"{label}serving decode, T = {T}"
                 + ("" if products == ("gate_up",) else f", {prod}"),
                 "variants": {}, "library_ms": None, "library_err": None}
            for name, x in routes.items():
                xt = x[:T]
                _, idx, _ = L.moe_router(p0, xt[None], K)
                idx = idx[0]
                dest, te, tp = _route(idx, T, K, E, tm)
                xs = torch.zeros((tp, D), dtype=xt.dtype, device=device)
                xs[dest] = xt.repeat_interleave(K, dim=0)
                w, k_in, n_out = p0["wg"], D, F
                if prod == "down":
                    g = GR.gmm_ref(xs, p0["wg"], te, tm)
                    u = GR.gmm_ref(xs, p0["wu"], te, tm)
                    xs = (torch.nn.functional.silu(g) * u).to(xt.dtype)
                    w, k_in, n_out = p0["wd"], F, D
                touched = int(torch.unique(idx).numel())
                nb = touched * k_in * n_out * 2 + T * K * k_in * 2 \
                    + T * K * n_out * 4
                sum_scale = GR.gmm_ref(xs.abs(), w.abs(), te, tm) \
                    if k_in > GMM_SUM_MIN_K else None
                v = variant_numbers(
                    lambda: G.gmm_cuda(xs, w, te, tm),
                    lambda: GR.gmm_ref(xs, w, te, tm), "gmm_tc_kernel",
                    on_card, reps, nb, 2 * T * K * k_in * n_out,
                    torch.bfloat16, GMM_ATOL, GMM_RTOL,
                    what=f"gmm decode T={T} {prod} {name}",
                    sum_scale=sum_scale)
                if sum_scale is not None:
                    v.update(max_sum_scale=float(sum_scale.max()),
                             tolerance="sum")
                del sum_scale
                counts = torch.bincount(idx.reshape(-1).long(), minlength=E)
                used = int(((counts + tm - 1) // tm).sum())
                v.update(touched_experts=touched, tp=tp, routed_rows=T * K,
                         tiles=tp // tm, used_tiles=used,
                         tail_tiles=tp // tm - used)
                e["variants"][name] = v
                grouped = getattr(torch, "_grouped_mm", None)
                if on_card and grouped is not None \
                        and e["library_ms"] is None:
                    counts = torch.bincount(idx.reshape(-1).long(),
                                            minlength=E)
                    offs = torch.cumsum((counts + tm - 1) // tm * tm,
                                        0).to(torch.int32)
                    rows = int(offs[-1])
                    lib = lambda: grouped(xs, w, offs=offs)
                    e["library_err"] = float((lib()[:rows].float()
                                              - GR.gmm_ref(xs, w, te, tm)
                                              [:rows]).abs().max())
                    e["library_ms"] = cuda_ms(lib, reps)[0]
            entries.append(e)
    return entries


def serve_solo(res, eng, model, params, reqs, policy, device) -> None:
    """Each stream of the burst against a fresh engine's solo run at the
    smallest buckets, and where the first one parts, the operator."""
    solo = []
    with fault_free("serving solo"):
        for r in reqs:
            s = eng.generate_solo(r.prompt, r.max_new_tokens)
            part = next((i for i, (a, b) in enumerate(zip(s, r.tokens))
                         if a != b), None)
            solo.append({"rid": r.rid, "equal": s == r.tokens,
                         "first_token_apart": part,
                         "buckets": sorted(set(r.decode_buckets))})
        res["solo"] = solo
        apart = [r for r, s in zip(reqs, solo) if not s["equal"]]
        if apart:
            r = apart[0]
            res["parting"] = parting_op(model, params, r, (
                policy.batch_bucket(1),
                policy.seq_bucket(r.prompt_len + r.max_new_tokens)), device)


def serve_faults(res, eng, model, params, scfg, seed, policy,
                 device) -> None:
    """The serving faults against the fault-free streams: decode_raise and
    decode_nan, a second replica's prewarm and replica_crash on the
    two-replica FrontDoor, then shadow_diverge:request."""
    from repro_torch.core import faults
    from repro_torch.core import resilience as R
    from repro_torch.serve import Engine, FrontDoor

    cfg = model.cfg
    with fault_free("serving fault-free reference"):
        clean = fault_requests(cfg, seed, policy)
        eng.run([(0.0, r) for r in clean])
    want = {r.rid: list(r.tokens) for r in clean}
    res["fault_free_buckets"] = sorted({b for r in clean
                                        for b in r.decode_buckets})
    faulted = {}
    for kind in ("decode_raise", "decode_nan"):
        got = fault_requests(cfg, seed, policy)
        with faults.inject(f"{kind}:decode:{SERVE_FAULT_P}",
                           seed=seed) as plan:
            (_, events) = _contained(
                lambda: eng.run([(0.0, r) for r in got]))
        survivors = [r for r in got if r.failed is None]
        faulted[kind] = {
            "fired": len(plan.fired), "events": events,
            "failed": [r.failed[:60] for r in got if r.failed],
            "survivors": len(survivors),
            "survivors_equal": all(list(r.tokens) == want[r.rid]
                                   for r in survivors),
            "buckets": sorted({b for r in got for b in r.decode_buckets})}
    res["faults"] = faulted

    # a second replica on the shared plan cache, then replica_crash
    t0 = time.perf_counter()
    with fault_free("serving second replica"):
        eng2 = Engine(model, params, scfg)
    res["replica2_prewarm"] = dict(
        eng2.metrics.prewarm, seconds=time.perf_counter() - t0,
        bake_errors=eng2._decode.plan_info()["bake_errors"])
    fd = FrontDoor([eng, eng2])
    got = fault_requests(cfg, seed, policy)
    for r in got:
        require(fd.submit(r), "serving: the front door takes the request")
    split = [sum(fd.assignment[r.rid] == k for r in got) for k in (0, 1)]
    for _ in range(2):
        fd.step()
    victim = fd.assignment[got[0].rid]
    with faults.inject(f"replica_crash:replica{victim}") as plan:
        fd.step()
    fd.run_until_idle()
    snapf = fd.snapshot()["fleet"]
    res["replica_crash"] = {
        "fired": len(plan.fired), "split": split, "victim": victim,
        "accounted": fd.accounted(), "failovers": fd.failovers,
        "redistributed": fd.redistributed, "lost": fd.lost,
        "finished": snapf["finished"],
        "streams_equal": all(list(r.tokens) == want[r.rid] for r in got),
        "buckets": sorted({b for r in got for b in r.decode_buckets})}
    del fd, eng2
    release(device)

    # shadow_diverge:request: a divergence quarantines the decode's K4
    os.environ[R.ENV_REQUEST_SHADOW] = "1"
    try:
        one = fault_requests(cfg, seed, policy, n=2)
        divs = eng.metrics.request_shadow_divergences
        with faults.inject("shadow_diverge:request") as plan:
            (_, events) = _contained(lambda: eng.run(
                [(0.0, one[0])]))
        divs = eng.metrics.request_shadow_divergences - divs
        q = R.shared_quarantine()
        quarantined = sorted(q.active())
        before = eng._decode.last_selections
        os.environ.pop(R.ENV_REQUEST_SHADOW, None)
        (_, after_events) = _contained(lambda: eng.run([(0.0, one[1])]))
        res["shadow_diverge"] = {
            "fired": len(plan.fired), "divergences": divs,
            "quarantined": quarantined, "events": len(events),
            "selections_before": sorted({n for _, n in before}),
            "selections_after": sorted({
                n for _, n in eng._decode.last_selections}),
            "after_events": len(after_events),
            "after_finished": one[1].failed is None
            and len(one[1].tokens) == one[1].max_new_tokens}
        q.clear()
    finally:
        os.environ.pop(R.ENV_REQUEST_SHADOW, None)


def serve_ragged(res, cfg, p0, gen, device) -> None:
    """moe_ffn_ragged on K4 against the padded baseline and the oracle."""
    import torch
    from repro_torch.kernels.moe_gmm import kernel as G
    from repro_torch.kernels.moe_gmm import ref as GR
    from repro_torch.models import layers as L
    from repro_torch.serve import moe_ffn_padded, moe_ffn_ragged, \
        padding_waste

    xs = [torch.randn((t, cfg.d_model), generator=gen, device=device)
          .to(cfg.param_dtype) for t in SERVE_RAGGED]
    routes = [L.moe_router(p0, x[None], cfg.moe_topk) for x in xs]
    gates, idxs = [g[0] for g, _, _ in routes], [i[0] for _, i, _ in routes]
    w = (p0["wg"], p0["wu"], p0["wd"])
    with fault_free("serving ragged"):
        G.reset_launches()
        ragged = moe_ffn_ragged(xs, gates, idxs, *w)
        ragged_launches = dict(G.LAUNCHES)
        padded = moe_ffn_padded(xs, gates, idxs, *w)
    rows = []
    for x, g, i, a, b in zip(xs, gates, idxs, ragged, padded):
        want_o = GR.moe_ffn_ref(x, g, i, *w)
        rows.append({"tokens": int(x.shape[0]), "ragged": rel_l2(a, want_o),
                     "padded": rel_l2(b, want_o)})
    res["ragged"] = {"lengths": list(SERVE_RAGGED), "rows": rows,
                     "launches": ragged_launches,
                     "padding_waste": padding_waste(SERVE_RAGGED)}


def inductor_prefill(cfg, seed: int, policy, reqs, device,
                     layers: int = SERVE_INDUCTOR_LAYERS) -> dict:
    """The engine's default compiled prefill (``jit_prefill`` with no
    ``compile_backend``: inductor on the card) of ``cfg`` cut to
    ``layers`` (parameters from ``seed``) at the prompt length of
    ``reqs[0]``, on the first two prompts of ``reqs`` at that length,
    against the eager prefill and the f32 oracle (the eager prefill of
    the parameters cast to f32): per prompt the relative L2 of the
    logits between each pair, the greedy token under each, the top-2
    margin of each, and, where the compiled token differs from the eager
    one, the gap between the two tokens under each; the entry's compile
    seconds and the median ms of each prefill (host clock to a sync)."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.models.spec import tree_map
    from repro_torch.serve import Engine, ServeConfig

    model = build_model(cfg.replace(n_layers=layers))
    params = model.init(torch.Generator(device=device).manual_seed(seed),
                        device)
    L = reqs[0].prompt_len
    prompts = [r.prompt for r in reqs if r.prompt_len == L][:2]
    eng = Engine(model, params, ServeConfig(buckets=policy, use_lilac=False,
                                            prewarm_on_start=False))

    def ms(fn):
        out = []
        for _ in range(5):
            sync(device)
            t0 = time.perf_counter()
            fn()
            sync(device)
            out.append(1e3 * (time.perf_counter() - t0))
        return sorted(out)[2]

    def tokens(q):
        return torch.as_tensor(q[None], device=device)

    got = [eng._prefill(q)[0].float() for q in prompts]
    info = eng.compile_info()
    eager = [model.prefill(params, {"tokens": tokens(q)})[0].float()
             for q in prompts]
    res = {"layers": layers, "length": L, "prompts": len(prompts),
           "backend": info["by_entry"][0]["backend"],
           "compiles": info["compiles"], "graph_breaks": info["graph_breaks"],
           "compile_s": info["compile_seconds"],
           "ms": ms(lambda: eng._prefill(prompts[0])),
           "eager_ms": ms(lambda: model.prefill(
               params, {"tokens": tokens(prompts[0])}))}
    del eng
    m32 = build_model(model.cfg.replace(param_dtype=torch.float32,
                                        cache_dtype=torch.float32))
    p32 = tree_map(lambda a: a.float(), params)
    oracle = [m32.prefill(p32, {"tokens": tokens(q)})[0].float()
              for q in prompts]
    del p32, params
    release(device)

    def top2(x):
        v = x.reshape(-1).topk(2).values
        return float(v[0] - v[1])

    rows = []
    for g, e, o in zip(got, eager, oracle):
        tg, te, to = (int(x.reshape(-1).argmax()) for x in (g, e, o))
        row = {"compiled_eager": rel_l2(g, e), "compiled_f32": rel_l2(g, o),
               "eager_f32": rel_l2(e, o), "tokens": [tg, te, to],
               "margins": [top2(g), top2(e), top2(o)]}
        if tg != te:
            row["gaps"] = [float(x.reshape(-1)[tg] - x.reshape(-1)[te])
                           for x in (g, e, o)]
        rows.append(row)
    res["rows"] = rows
    return res


def serve_path(seed: int, device, cfg=None, policy=None,
               n_requests: int = SERVE_REQUESTS, light: bool = False,
               f32: bool = True, jit_prefill: bool = False,
               backend: str = SERVE_BACKEND) -> dict:
    """A MoE model at full width served by repro_torch.serve (OLMoE-1B-7B
    unless ``cfg`` names another): the engine's prewarm over ``policy``'s
    grid, a closed burst of ``n_requests`` on baked plans (launches
    counted from 0), the teacher-forced comparison with the uncompiled
    decode, batched against solo streams, a fault-free run at
    request-shadow rate 1, an uncompiled engine's run, the serving faults
    (decode_raise, decode_nan, replica_crash on a 2-replica front door,
    shadow_diverge:request), moe_ffn_ragged on K4, K4 at the decode shapes,
    and one decode step under torch.profiler.  ``light`` leaves out what
    does not depend on the model and OLMoE's phase shows: batched against
    solo, the faults, the second replica and moe_ffn_ragged; K4 at the
    decode shapes then times the down product too.  Without ``f32`` the
    teacher-forced comparison has no f32 part (``compiled_f32``), for a
    model that cannot be held in f32 beside its bf16 copy.  With
    ``jit_prefill`` the served engine compiles its prefill, cache-row
    install and slot move (``backend``) at SERVE_PROMPT_GRID in its
    prewarm, and the compiles on the request path are counted; the other
    engines (the uncompiled run's, the second replica) prefill eagerly."""
    import torch
    from repro_torch.configs.olmoe_1b_7b import CONFIG as OLMOE
    from repro_torch.core import resilience as R
    from repro_torch.kernels.common import COUNTERS
    from repro_torch.models import build_model
    from repro_torch.models import transformer as T
    from repro_torch.serve import BucketPolicy, Engine, ServeConfig

    cfg = (cfg or OLMOE).replace(moe_decode_impl="naive_flat")
    moe_blocks = [f"b{i}" for i, (_, ff) in enumerate(T.arch_pattern(cfg))
                  if ff == "moe"]
    policy = policy or BucketPolicy(batch=SERVE_BATCH, seq=SERVE_SEQ)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(seed + 17),
                        device)
    sync(device)
    res = {"config": {"name": cfg.name, "layers": cfg.n_layers,
                      "d_model": cfg.d_model, "heads": cfg.n_heads,
                      "experts": cfg.moe_experts, "topk": cfg.moe_topk,
                      "d_ff": cfg.d_ff, "vocab": cfg.vocab,
                      "moe_layers": len(moe_blocks) * T.n_periods(cfg),
                      "params": model.param_count(),
                      "grid": [list(g) for g in policy.grid()]},
           "init_s": time.perf_counter() - t0, "light": light,
           "cache_bytes": {f"{b}x{s}": cache_bytes(model, (b, s))
                           for b, s in policy.grid()}}
    scfg = ServeConfig(mode="continuous", buckets=policy, jit_prefill=False)
    ecfg = scfg.replace(jit_prefill=True, prefill_lengths=SERVE_PROMPT_GRID,
                        compile_backend=backend) if jit_prefill else scfg

    def reset_counts():
        for c in COUNTERS:
            c.update(dict.fromkeys(c, 0))

    def counts():
        return {k: v for c in COUNTERS for k, v in c.items() if v}

    # (a) prewarm, then the burst on baked plans
    t0 = time.perf_counter()
    with fault_free("serving prewarm"):
        eng = Engine(model, params, ecfg)
    res["prewarm_s"] = time.perf_counter() - t0
    res["jit_prefill"] = jit_prefill
    res["prefill_compile_prewarm"] = eng.compile_info()
    res["prewarm"] = eng.metrics.prewarm
    res["prewarm_bake_errors"] = eng._decode.plan_info()["bake_errors"]
    res["prewarm_bytes"] = (torch.cuda.memory_allocated(device),
                            torch.cuda.max_memory_allocated(device)) \
        if device.type == "cuda" else None
    detects = eng._decode.stats["detects"]
    grid = SERVE_PROMPT_GRID if jit_prefill else ()
    wseed = res["workload_seed"] = serve_seed(cfg, seed, policy, n_requests,
                                              grid)
    reqs = serve_requests(cfg, wseed, n_requests, grid=grid)
    before = memory_mark(device)
    reset_counts()
    with fault_free("serving"):
        sync(device)
        t0 = time.perf_counter()
        snap = eng.run([(0.0, r) for r in reqs])
        sync(device)
        wall = time.perf_counter() - t0
    res["launches"] = counts()
    peak, _ = memory_read(device, before)
    tokens = sum(len(r.tokens) for r in reqs)
    res.update(
        run_s=wall, tokens=tokens, tokens_per_s=tokens / wall,
        peak_bytes=peak or 0, steps=snap["steps"],
        request_detects=eng._decode.stats["detects"] - detects,
        bucket_misses=snap["buckets"]["misses"],
        cache_resizes=snap["buckets"]["cache_resizes"],
        ttft_s=snap["ttft_s"], prefill_s=snap["prefill_s"],
        decode_step_s=snap["decode_step_s"],
        occupancy=snap["batch_occupancy"],
        buckets_used=sorted({b for r in reqs for b in r.decode_buckets}),
        failed=[r.failed for r in reqs if r.failed],
        streams=[list(r.tokens) for r in reqs],
        plans=_plan_rows(eng._decode, _k_leaf(model, params)),
        matches=[[m.computation for m in e.report.matches]
                 for e in eng._decode._compiled.values()],
        selections=sorted({n for _, n in eng._decode.last_selections}),
        prefill_compile_run=eng.compile_info())

    # one decode step at the largest bucket under torch.profiler
    if device.type == "cuda":
        big = policy.grid()[-1]
        c = model.init_cache(*big, device=device)
        tok = torch.ones((big[0], 1), dtype=torch.int32, device=device)
        pos = torch.full((big[0],), big[1] // 2, dtype=torch.int32,
                         device=device)
        for _ in range(2):
            _, c = eng._decode(params, c, tok, pos)
        res["decode_profile"] = step_breakdown(
            lambda: eng._decode(params, c, tok, pos), device)
        res["decode_profile"]["bucket"] = list(big)
        del c
    release(device)

    # (b) teacher-forced: compiled against uncompiled on two streams
    with fault_free("serving teacher-forced"):
        tf = teacher_forced(eng, model, params, reqs[:2], device, f32=f32)
        tf["moe_layers"] = moe_layers(eng, model, params, reqs[:2], device)
    router_input = tf.pop("router_input")
    res["teacher_forced"] = tf
    if jit_prefill:
        with fault_free("serving inductor prefill"):
            res["inductor_prefill"] = inductor_prefill(cfg, seed + 23, policy,
                                                       reqs, device)

    # (c) batched against solo, then the request shadow at rate 1
    if not light:
        serve_solo(res, eng, model, params, reqs, policy, device)
    checks, divs = (eng.metrics.request_shadow_checks,
                    eng.metrics.request_shadow_divergences)
    os.environ[R.ENV_REQUEST_SHADOW] = "1"
    try:
        with fault_free("serving request shadow"):
            again = serve_requests(cfg, wseed, n_requests, grid=grid)
            eng.run([(0.0, r) for r in again])
    finally:
        os.environ.pop(R.ENV_REQUEST_SHADOW, None)
    info = eng._decode.resilience_info()
    res["shadow"] = {
        "checks": eng.metrics.request_shadow_checks - checks,
        "divergences": eng.metrics.request_shadow_divergences - divs,
        "streams_equal_first_run": [list(r.tokens) for r in again]
        == res["streams"],
        "quarantine_active": info["quarantine_active"],
        "containment": info["containment"]}
    release(device)

    # the same burst on an uncompiled engine (the naive dense dispatch)
    ueng = Engine(model, params, scfg.replace(use_lilac=False))
    plain = serve_requests(cfg, wseed, n_requests, grid=grid)
    sync(device)
    t0 = time.perf_counter()
    usnap = ueng.run([(0.0, r) for r in plain])
    sync(device)
    res["uncompiled"] = {
        "run_s": time.perf_counter() - t0, "steps": usnap["steps"],
        "decode_step_s": usnap["decode_step_s"],
        "streams_equal": [list(r.tokens) for r in plain] == res["streams"],
        "tokens_apart": sum(a != b for r, s in zip(plain, res["streams"])
                            for a, b in zip(r.tokens, s))}
    del ueng
    release(device)

    if not light:
        serve_faults(res, eng, model, params, scfg, seed, policy, device)
    res["prefill_compile_end"] = eng.compile_info()
    del eng
    release(device)

    # the first MoE layer's weights, whose router input teacher_forced kept
    p0 = {k: v[0] for k, v in params["blocks"][moe_blocks[0]]["moe"].items()}
    gen = torch.Generator(device=device).manual_seed(seed + 19)
    if not light:
        serve_ragged(res, cfg, p0, gen, device)

    # K4 at the decode shapes: the model's layer-0 routes, unit normal
    unit = torch.randn(router_input.reshape(-1, cfg.d_model).shape,
                       generator=gen, device=device).to(cfg.param_dtype)
    res["gmm_decode"] = gmm_decode_phases(
        cfg, p0, {"model routes": router_input.reshape(-1, cfg.d_model),
                  "unit-normal routes": unit}, device,
        products=("gate_up", "down") if light else ("gate_up",),
        label=f"{cfg.name} " if light else "")
    return res


def check_serve_path(res) -> None:
    layers = res["config"]["moe_layers"]
    pw = res["prewarm"]
    grid = len(res["config"]["grid"])
    require(pw["baked"] == pw["n_signatures"] == grid,
            f"serving: prewarm bakes every grid point, got {pw}")
    if res.get("jit_prefill"):
        w = res["prefill_compile_prewarm"]
        require(pw["prefill_warmed"] == list(SERVE_PROMPT_GRID)
                and w["compiles"] >= w["entries"] > 0
                and res["prefill_compile_run"]["request_path_compiles"] == 0
                and res["prefill_compile_end"]["request_path_compiles"] == 0,
                f"serving: the prefill, install and move compiled in the "
                f"prewarm at {SERVE_PROMPT_GRID}, none on the request path, "
                f"got {pw['prefill_warmed']}, {w['compiles']} graphs, "
                f"{res['prefill_compile_run']['request_path_compiles']} and "
                f"{res['prefill_compile_end']['request_path_compiles']} "
                f"request-path compiles")
        ip = res["inductor_prefill"]
        require(ip["backend"] == "inductor" and ip["compiles"] == 1
                and ip["graph_breaks"] == 0 and all(
                    r["compiled_eager"] <= max(SERVE_LOGIT_RTOL,
                                               SERVE_PREFILL_FACTOR
                                               * r["eager_f32"])
                    for r in ip["rows"]),
                f"serving: the engine's default prefill compiles with "
                f"inductor as one graph and its logits are within "
                f"{SERVE_PREFILL_FACTOR}x the eager prefill's distance from "
                f"the f32 oracle (at least {SERVE_LOGIT_RTOL}) of the eager "
                f"ones, got {ip['backend']}, "
                f"{ip['compiles']} graphs, {ip['graph_breaks']} breaks, "
                f"{ip['rows']}")
    require(res["request_detects"] == 0 and res["bucket_misses"] == 0,
            f"serving: no detection and no bucket miss on the request "
            f"path, got {res['request_detects']} detects and "
            f"{res['bucket_misses']} misses")
    require(all(m == ["moe_ffn"] * layers for m in res["matches"])
            and len(res["matches"]) == grid,
            f"serving: one moe_ffn match a MoE layer in each signature, got "
            f"{res['matches']}")
    require(all(p["selections"] == ["cuda.gmm"]
                and p["moe_matches"] == layers for p in res["plans"])
            and len(res["plans"]) == grid,
            f"serving: each bucket's plan runs cuda.gmm in every layer, got "
            f"{res['plans']}")
    require(res["launches"].get("gmm") == 3 * layers * res["steps"],
            f"serving: K4 launches 3 x {layers} layers x {res['steps']} "
            f"decode steps, got {res['launches']}")
    require(not res["failed"] and len({b for b, _ in res["buckets_used"]})
            > 1 and len({s for _, s in res["buckets_used"]}) > 1,
            f"serving: every request finishes, the batch and seq buckets "
            f"both change, got failures {res['failed']} and buckets "
            f"{res['buckets_used']}")
    tf = res["teacher_forced"]
    ml = tf["moe_layers"]
    require(ml["plan"] and ml["harnesses"] == ["cuda.gmm"] * layers
            and ml["max_rel_l2"] <= SERVE_LOGIT_RTOL
            and ml["replay_rel_l2"] <= SERVE_F32_RTOL,
            f"serving: one compiled bf16 decode step, each of the {layers} "
            f"MoE layers on cuda.gmm within relative L2 {SERVE_LOGIT_RTOL} "
            f"of the naive dense dispatch on the layer's own input, and the "
            f"recorded program within {SERVE_F32_RTOL} of the CUDA graph's "
            f"replay, got {ml.get('harnesses')}, "
            f"{ml.get('max_rel_l2', float('nan')):.3g} and "
            f"{ml.get('replay_rel_l2', float('nan')):.3g}")
    require(all(tf["first_token_agrees"])
            and tf["same_moe"]["max_rel_l2"] <= SERVE_LOGIT_RTOL
            and tf["f32"]["max_rel_l2"] <= SERVE_F32_RTOL,
            f"serving: teacher-forced, the prefill's first tokens agree, at "
            f"every step the compiled bf16 decode's logits are within "
            f"relative L2 {SERVE_LOGIT_RTOL} of the uncompiled decode's "
            f"whose MoE computes K4's function (the rewrite and the plans), "
            f"and the compiled f32 decode (K4's f32 body) within "
            f"{SERVE_F32_RTOL} of the uncompiled naive one, got "
            f"{tf['first_token_agrees']}, {tf['same_moe']['max_rel_l2']:.3g} "
            f"and {tf['f32']['max_rel_l2']:.3g}")
    sh = res["shadow"]
    require(sh["checks"] == len(res["streams"]) and sh["divergences"] == 0
            and sh["quarantine_active"] == 0
            and sh["containment"]["contained_exceptions"] == 0,
            f"serving: the request shadow at rate 1 checks every request "
            f"with 0 divergences, got {sh}")
    if not res["light"]:
        check_serve_faults(res, grid)


def check_serve_faults(res, grid: int) -> None:
    """The checks of ``serve_faults`` and ``serve_ragged``."""
    for kind, f in res["faults"].items():
        want_reason = "decode:" if kind == "decode_raise" \
            else "non-finite decode logits"
        require(f["fired"] > 0 and f["failed"] and f["survivors"] > 0
                and all(x.startswith(want_reason) for x in f["failed"])
                and f["survivors_equal"],
                f"serving: {kind} evicts the poisoned slots with their "
                f"reason and the survivors' streams equal the fault-free "
                f"run's, got {f}")
    rc = res["replica_crash"]
    require(rc["fired"] == 1 and rc["accounted"] and rc["lost"] == 0
            and rc["failovers"] == 1 and rc["streams_equal"],
            f"serving: replica_crash loses no request and the streams equal "
            f"the fault-free run's, got {rc}")
    require(res["replica2_prewarm"]["detect_calls"] == 0
            and res["replica2_prewarm"]["baked"] == grid,
            f"serving: a second replica's prewarm detects nothing, got "
            f"{res['replica2_prewarm']}")
    sd = res["shadow_diverge"]
    require(sd["divergences"] == 1
            and any(k.startswith("moe_ffn|cuda.gmm") for k in sd["quarantined"])
            and sd["selections_before"] == ["cuda.gmm"]
            and "cuda.gmm" not in sd["selections_after"]
            and sd["after_finished"],
            f"serving: shadow_diverge:request reports a divergence, "
            f"quarantines cuda.gmm and the next decode runs without it, "
            f"got {sd}")
    rg = res["ragged"]
    require(all(r["ragged"] <= MOE_RTOL and r["padded"] <= MOE_RTOL
                for r in rg["rows"]) and rg["launches"].get("gmm") == 3,
            f"serving: moe_ffn_ragged (3 K4 launches) and moe_ffn_padded "
            f"within relative L2 {MOE_RTOL} of the f32 oracle, got {rg}")


def print_serve_faults(sv, tag: str) -> None:
    r2 = sv["replica2_prewarm"]
    print(f"{tag} second replica prewarm: {r2['baked']} baked, "
          f"{r2['detect_calls']} detections, {r2['plan_cache_hits']} from "
          f"the plan cache, in {r2['seconds']:.1f}s")
    eq = sum(s["equal"] for s in sv["solo"])
    print(f"{tag} batched vs solo (a fresh engine's buckets): {eq} of "
          f"{len(sv['solo'])} streams equal; " + "; ".join(
              f"rid {s['rid']} apart from token {s['first_token_apart']} "
              f"(batched at {s['buckets']})"
              for s in sv["solo"] if not s["equal"]))
    if "parting" in sv:
        print(f"{tag} where the logits part: {sv['parting']}")
    for kind, f in sv["faults"].items():
        print(f"{tag} {kind} (p {SERVE_FAULT_P}): {f}")
    print(f"{tag} replica_crash: {sv['replica_crash']}; fault-free "
          f"buckets {sv['fault_free_buckets']}")
    print(f"{tag} shadow_diverge:request: {sv['shadow_diverge']}")
    print(f"{tag} moe_ffn_ragged at {sv['ragged']['lengths']} tokens "
          f"(padding waste {sv['ragged']['padding_waste']:.3f}): relative "
          f"L2 vs the f32 oracle " + ", ".join(
              f"{r['tokens']}: K4 {r['ragged']:.3g} / padded "
              f"{r['padded']:.3g}" for r in sv["ragged"]["rows"])
          + f"; launches {sv['ragged']['launches']}")


def print_serve_path(sv, tag: str = "serving") -> None:
    c = sv["config"]
    print(f"{tag} {c['name']} (d_model {c['d_model']}, {c['heads']} heads, "
          f"{c['experts']} experts of d_ff {c['d_ff']} top-{c['topk']}, vocab "
          f"{c['vocab']}, {c['layers']} layers): {c['params']} params, "
          f"initialized in {sv['init_s']:.1f}s; the child process took "
          f"{sv['seconds']:.1f}s")
    pw = sv["prewarm"]
    print(f"{tag} prewarm {pw['baked']}/{pw['n_signatures']} baked in "
          f"{sv['prewarm_s']:.1f}s, {pw['detect_calls']} detections; per "
          f"signature " + ", ".join(
              f"{tuple(g)} {x['seconds']:.2f}s" for g, x in zip(
                  pw["grid"], pw["signatures"])))
    pct = lambda d: f"p50 {1e3 * d['p50']:.2f} ms, p99 {1e3 * d['p99']:.2f} ms"
    print(f"{tag} run: {len(sv['streams'])} requests, {sv['steps']} decode "
          f"steps, {sv['tokens']} tokens in {sv['run_s']:.2f}s "
          f"({sv['tokens_per_s']:.1f} tokens/s); TTFT {pct(sv['ttft_s'])}; "
          f"prefill {pct(sv['prefill_s'])}; decode step (compiled) "
          f"{pct(sv['decode_step_s'])}, uncompiled "
          f"{pct(sv['uncompiled']['decode_step_s'])}; occupancy "
          f"{sv['occupancy']:.3f}; buckets {sv['buckets_used']} "
          f"({sv['cache_resizes']} resizes); peak "
          f"{sv['peak_bytes'] / 2**30:.2f} GiB; request-path detections "
          f"{sv['request_detects']}, bucket misses {sv['bucket_misses']}; "
          f"launches {sv['launches']}")
    if sv.get("jit_prefill"):
        w, r, e = (sv["prefill_compile_prewarm"], sv["prefill_compile_run"],
                   sv["prefill_compile_end"])
        print(f"{tag} compiled admission (jit_prefill, "
              f"{w['by_entry'][0]['backend'] if w['by_entry'] else '-'}): "
              f"prefill warmed at {pw['prefill_warmed']} in "
              f"{pw.get('prefill_warm_seconds', 0.0):.1f}s of the prewarm's "
              f"{sv['prewarm_s']:.1f}s, {w['entries']} entries, "
              f"{w['compiles']} graphs, {w['graph_breaks']} graph breaks; "
              f"compiles on the request path at prewarmed lengths: "
              f"{r['request_path_compiles']} in the run, "
              f"{e['request_path_compiles']} by the phase's end; by entry "
              + ", ".join(f"{'/'.join(map(str, x['key']))} "
                          f"{x['compile_seconds']:.1f}s"
                          for x in w["by_entry"]))
        ip = sv["inductor_prefill"]
        rels = lambda k: [float(f"{r[k]:.3g}") for r in ip["rows"]]
        print(f"{tag} default prefill ({ip['backend']}, {ip['layers']} "
              f"layers, length {ip['length']}, {ip['prompts']} prompts): "
              f"{ip['compiles']} "
              f"graph, {ip['graph_breaks']} breaks, compiled in "
              f"{ip['compile_s']:.1f}s; {ip['ms']:.2f} ms a prefill against "
              f"the eager {ip['eager_ms']:.2f} ms (median of 5); relative L2 "
              f"of the logits, compiled against eager "
              f"{rels('compiled_eager')} (tol {SERVE_PREFILL_FACTOR}x eager "
              f"against f32, at least {SERVE_LOGIT_RTOL}), against f32 "
              f"{rels('compiled_f32')}, eager "
              f"against f32 {rels('eager_f32')}; "
              f"tokens (compiled, eager, f32) "
              f"{[r['tokens'] for r in ip['rows']]}; top-2 margins "
              f"{[[round(m, 4) for m in r['margins']] for r in ip['rows']]}"
              f"; gaps where the token differs "
              f"{[r.get('gaps') for r in ip['rows']]}")
    u = sv["uncompiled"]
    print(f"{tag} uncompiled engine: {u['steps']} steps in "
          f"{u['run_s']:.2f}s; streams equal to the compiled run's: "
          f"{u['streams_equal']} ({u['tokens_apart']} tokens apart)")
    for p in sv["plans"]:
        b = sv["cache_bytes"][f"{p['bucket'][0]}x{p['bucket'][1]}"]
        print(f"{tag} plan {tuple(p['bucket'])}: "
              f"{'CUDA graph' if p['cuda_graph'] else 'eager'}, "
              f"graph_copy_bytes {p['graph_copy_bytes']} (cache {b} B; the "
              f"functional cache update copies {2 * b} B a step), "
              f"recaptures {p['recaptures']}, replay {_ms(p['replay_ms'])} "
              f"ms / eager {_ms(p['eager_ms'])} ms, {p['hits']} hits, "
              f"{p['moe_matches']} x {p['selections']}")
    if "decode_profile" in sv:
        pr = sv["decode_profile"]
        print(f"{tag} decode step {tuple(pr['bucket'])} profiled: "
              f"{pr['wall_ms']:.2f} ms wall, {pr['kernel_ms']:.2f} ms of "
              f"kernels (idle share {pr['idle_share']:.3f}); by kind "
              f"{ {k: round(v, 3) for k, v in pr['by_kind_ms'].items()} }; "
              f"top {pr['top']}")
    tf = sv["teacher_forced"]
    med = lambda v: sorted(v)[len(v) // 2]
    for name, r, tol in (
            ("bf16", tf, "none (ROADMAP D2)"),
            ("bf16, the uncompiled decode's MoE on K4's function",
             tf["same_moe"], SERVE_LOGIT_RTOL),
            ("f32", tf["f32"], SERVE_F32_RTOL)):
        print(f"{tag} teacher-forced {name} {tuple(tf['shape'])}, "
              f"{tf['steps']} steps: relative L2 of the logits, compiled "
              f"against uncompiled, max {r['max_rel_l2']:.3g} (median "
              f"{med(r['rel_l2']):.3g}, first {r['rel_l2'][0]:.3g}; tol "
              f"{tol}), first tokens agree "
              f"{r['first_token_agrees']}; step ms compiled "
              f"{med(r['ms_compiled']):.2f}, uncompiled "
              f"{med(r['ms_uncompiled']):.2f} (median, host clock to a "
              f"sync)")
    for k, v in tf.get("bf16_to_f32", {}).items():
        print(f"{tag} teacher-forced bf16 {k} against the f32 oracle: "
              f"relative L2 max {max(v):.3g}, median {med(v):.3g}, first "
              f"{v[0]:.3g}")
    ml = tf["moe_layers"]
    if ml["plan"]:
        print(f"{tag} MoE layers of one compiled bf16 decode step "
              f"{tuple(ml['shape'])}: {len(ml['rel_l2'])} x "
              f"{sorted(set(ml['harnesses']))}; relative L2 against the "
              f"naive dispatch on the same input max {ml['max_rel_l2']:.3g} "
              f"(median {med(ml['rel_l2']):.3g}; tol {SERVE_LOGIT_RTOL}); "
              f"against the f32 oracle K4 max "
              f"{max(a for a, _ in ml['to_f32']):.3g}, naive max "
              f"{max(b for _, b in ml['to_f32']):.3g}; the program against "
              f"the graph's replay {ml['replay_rel_l2']:.3g}")
    print(f"{tag} prewarm bake errors {sv['prewarm_bake_errors']}, "
          f"memory after prewarm (allocated, peak) {sv['prewarm_bytes']}")
    print(f"{tag} request shadow at rate 1 (solo replays at the batched "
          f"buckets): {sv['shadow']}")
    if sv["light"]:
        print(f"{tag}: batched against solo, the faults, the second replica "
              f"and moe_ffn_ragged left out (OLMoE's serving phase runs "
              f"them)")
    else:
        print_serve_faults(sv, tag)
    for e in sv["gmm_decode"]:
        for name, v in e["variants"].items():
            print(f"gmm {e['path']} ({name}: {v['routed_rows']} routed rows "
                  f"of Tp {v['tp']}, {v['touched_experts']} experts; "
                  f"{v['used_tiles']} of {v['tiles']} row tiles used, "
                  f"{v['tail_tiles']} tail): "
                  f"{_ms(v['ms'])} ms (host {_ms(v['host_ms'])} ms; "
                  f"profiler {v['profiler_ms']} ms), plain "
                  f"{_ms(v['plain_ms'])} ms, bound {v['bound_ms']:.5f} ms "
                  f"({v['bound_by']}: {v['bytes']} B), max|err| "
                  f"{v['max_abs_err']:.3g}"
                  + (f" (tol {GMM_ATOL} + {GMM_SUM_RTOL:.3g} x |x|@|w|, "
                     f"at most {v['max_sum_scale']:.4g})"
                     if "max_sum_scale" in v else ""))
        print(f"gmm {e['path']} library (torch._grouped_mm, same rows): "
              f"{_ms(e['library_ms'])} ms, max|err| vs plain "
              f"{e['library_err']}")


# ---------------------------------------------------------------------------
# RWKV-6 1.6B at full width, RWKV_LAYERS deep: a recurrent decode state
# ---------------------------------------------------------------------------

RWKV_BATCH, RWKV_PROMPT, RWKV_STEPS = 2, 512, 16
# cut from 24: the distributed phase's recurrent mixers (~180 s) took the
# script to 1,069.4 s at 24, 1,170.3 s at 12 on a slower host
RWKV_LAYERS = 6
RWKV_F32_RTOL = 1e-3      # decode after prefill against the longer prefill
RWKV_BF16_SPREAD = 2.0    # bf16 decode's error from f32 over the prefill's
RWKV_BF16_LAYER_RTOL = 3e-3   # a layer's bf16 decode against its forward


def rwkv_layers(cfg, p, tokens, prompt: int, steps: int):
    """Layer by layer through the port's block functions: the residual
    stream after each layer of the forward over all the tokens, and each
    layer's decode held against that forward on the layer's own inputs
    (its state set up by ``apply_block`` over the layer's first
    ``prompt`` inputs, then ``steps`` ``decode_block`` calls fed the
    forward's inputs at the next positions).  Returns (the residual
    streams, embedding first; per layer the relative L2 of the decode's
    block updates, output less input, over the ``steps`` steps against
    the forward's).  A layer's distance is the rounding of that one
    layer, free of what the layers below it did."""
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.models.spec import tree_map

    (mixer, ffn), = T.arch_pattern(cfg)
    x = p["embed"][tokens.long()]
    xs, dist = [x], []
    for j in range(T.n_periods(cfg)):
        bp = tree_map(lambda a: a[j], p["blocks"])["b0"]
        y, _, _ = T.apply_block(cfg, bp, x, mixer=mixer, ffn=ffn,
                                positions=None)
        _, _, ce = T.apply_block(cfg, bp, x[:, :prompt], mixer=mixer,
                                 ffn=ffn, positions=None)
        got = []
        for t in range(prompt, prompt + steps):
            yt, ce = T.decode_block(cfg, bp, x[:, t:t + 1], ce, None,
                                    mixer=mixer, ffn=ffn)
            got.append(yt[:, 0])
        xt = x[:, prompt:prompt + steps].float()
        dist.append(rel_l2(torch.stack(got, 1).float() - xt,
                           y[:, prompt:prompt + steps].float() - xt))
        xs.append(y)
        x = y
    return xs, dist
# Jamba's Mamba layers, each layer's bf16 decode against its forward on
# the layer's own inputs (relative L2 over MAMBA_STEPS steps): between
# what the bf16 rounding of one mixer reads at full width on the CPU
# (port 6.4e-4-1.1e-3, reference 1.9e-4-4.6e-4) and what one extra bf16
# rounding of the state between decode steps reads (2.8e-3-2.9e-3;
# tests/test_torch_mamba.py, run as a script)
MAMBA_BF16_LAYER_RTOL = 2e-3
MAMBA_F32_LAYER_RTOL = 1e-3
MAMBA_PROMPT, MAMBA_STEPS = 512, 32


def mamba_layers(cfg, p, tokens, prompt: int, steps: int,
                 f32: bool = False) -> dict:
    """Layer by layer through the port's block functions (the forward's
    MoE the naive dense dispatch, which the decode's ``naive_flat``
    computes too): the residual stream after each layer (embedding
    first), and each Mamba layer's mixer held against its forward on the
    layer's own input, the normed stream ``ln1(x)``: the state from
    ``mamba_block`` over the first ``prompt`` inputs, then ``steps``
    one-token calls carrying ``(ssm, conv)`` as ``decode_block`` does,
    against ``mamba_block`` over all the inputs from a zero state (the
    relative L2 of the ``steps`` outputs).  With ``f32`` an f32 copy of
    the model runs beside, each block's parameters cast when it runs (a
    full-width Jamba MoE block is 11.8 GB in f32, the model 104 GB).
    Returns {"model": run[, "f32": run]}, a run {"streams": [...],
    "decode": {layer index: relative L2}}."""
    import torch

    from repro_torch.models import mamba as M
    from repro_torch.models import transformer as T
    from repro_torch.models.spec import tree_map

    pattern = T.arch_pattern(cfg)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    x = p["embed"][tokens.long()]
    runs = {"model": (cfg, lambda a: a, x)}
    if f32:
        runs["f32"] = (cfg.replace(param_dtype=torch.float32,
                                   cache_dtype=torch.float32),
                       lambda a: a.float(), x.float())
    out = {k: {"streams": [x0], "decode": {}}
           for k, (_, _, x0) in runs.items()}
    for j in range(T.n_periods(cfg)):
        for i, (mixer, ffn) in enumerate(pattern):
            layer = j * len(pattern) + i
            for name, (c, cast, _) in runs.items():
                bp = tree_map(lambda a: cast(a[j]), p["blocks"][f"b{i}"])
                x = out[name]["streams"][-1]
                if mixer == "mamba":
                    h = T._norm_apply(c, bp["ln1"], x)
                    zero = (torch.zeros((B, 2 * c.d_model, c.d_state),
                                        dtype=torch.float32, device=x.device),
                            torch.zeros((B, M.CONV_K - 1, 2 * c.d_model),
                                        dtype=torch.float32, device=x.device))
                    full, _ = M.mamba_block(bp["mamba"], h, zero, c.d_state)
                    _, state = M.mamba_block(bp["mamba"], h[:, :prompt], zero,
                                             c.d_state)
                    got = []
                    for t in range(prompt, prompt + steps):
                        y, state = M.mamba_block(bp["mamba"], h[:, t:t + 1],
                                                 state, c.d_state)
                        got.append(y)
                    out[name]["decode"][layer] = rel_l2(
                        torch.cat(got, 1), full[:, prompt:prompt + steps])
                    del full, h
                y, _, _ = T.apply_block(c, bp, x, mixer=mixer, ffn=ffn,
                                        positions=positions, moe_impl="naive")
                out[name]["streams"].append(y)
                del bp
    return out


def decode_against_forward(m, p, tokens, prompt: int, steps: int,
                           device):
    """``Model.prefill`` on the first ``prompt`` tokens, then ``steps``
    teacher-forced ``Model.decode`` steps; per step the decode's logits
    and the full-sequence forward's at the same position (the forward's
    MoE ``m.cfg.moe_impl``)."""
    import torch
    from repro_torch.models import transformer as T

    with torch.no_grad():
        x, _, _ = T.forward(m.cfg, p, {"tokens": tokens})
        full = torch.einsum("bsd,dv->bsv", x[:, prompt - 1:].float(),
                            p["unembed"].float())
        del x
        logits, caches = m.prefill(p, {"tokens": tokens[:, :prompt]})
        cache = m.cache_from_prefill(caches, prompt, prompt + steps)
        got = [logits]
        for t in range(steps):
            logits, cache = m.decode(p, cache, tokens[:, prompt + t:][:, :1],
                                     torch.tensor(prompt + t, device=device))
            got.append(logits)
    return got, full


RWKV_BURST = 4
RWKV_BUCKETS = ((1, 4), (512,))


def rwkv_path(seed: int, device, cfg=None, prompt: int = RWKV_PROMPT,
              steps: int = RWKV_STEPS, burst: int = RWKV_BURST,
              buckets=RWKV_BUCKETS) -> dict:
    """RWKV-6 through the entry points a user calls: ``build_model``,
    ``Model.prefill`` on RWKV_BATCH x ``prompt`` tokens, then ``steps``
    teacher-forced ``Model.decode`` steps, held against the full-sequence
    forward over the ``prompt + steps`` tokens: in f32 (relative L2 of
    each step's logits) and in bf16 (each step's argmax); the prefill's
    and a decode step's ms (CUDA events); then ``build_engine`` (full
    size) serving a burst of ``burst`` requests of equal length at one
    batch bucket: what lilac.compile detects in the decode step, and each
    stream against the uncompiled decode teacher-forced at the engine's
    bucket from the same prefills."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.models import transformer as T
    from repro_torch.models.spec import tree_map
    from repro_torch.serve import BucketPolicy, ServeConfig, build_engine

    cfg = cfg or get_arch("rwkv6-1.6b").replace(n_layers=RWKV_LAYERS)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(seed + 23),
                        device)
    sync(device)
    res = {"config": {"name": cfg.name, "layers": cfg.n_layers,
                      "d_model": cfg.d_model, "heads": cfg.n_heads,
                      "d_ff": cfg.d_ff, "vocab": cfg.vocab,
                      "params": model.param_count()},
           "init_s": time.perf_counter() - t0, "prompt": prompt,
           "steps": steps}
    gen = torch.Generator(device="cpu").manual_seed(seed + 29)
    tokens = torch.randint(1, cfg.vocab, (RWKV_BATCH, prompt + steps),
                           generator=gen, dtype=torch.int32).to(device)

    def run(m, p):
        return decode_against_forward(m, p, tokens, prompt, steps, device)

    def agree(a, b):
        return bool(torch.equal(a.argmax(-1), b.argmax(-1)))

    got, full = run(model, params)
    m32 = build_model(cfg.replace(param_dtype=torch.float32,
                                  cache_dtype=torch.float32))
    p32 = tree_map(lambda a: a.float(), params)
    got32, full32 = run(m32, p32)
    res["f32"] = {"rel_l2": [rel_l2(g, full32[:, t])
                             for t, g in enumerate(got32)],
                  "argmax_agree": [agree(g, full32[:, t])
                                   for t, g in enumerate(got32)]}
    res["f32"]["max_rel_l2"] = max(res["f32"]["rel_l2"])
    # bf16: each path against the other, and each against the f32 oracle
    # (the f32 forward over the longer sequence)
    res["bf16"] = {
        "argmax_agree": [agree(g, full[:, t]) for t, g in enumerate(got)],
        "rel_l2": [rel_l2(g, full[:, t]) for t, g in enumerate(got)],
        "decode_to_f32": [rel_l2(g, full32[:, t])
                          for t, g in enumerate(got)],
        "prefill_to_f32": [rel_l2(full[:, t], full32[:, t])
                           for t in range(len(got))],
        "decode_agrees_f32": [agree(g, full32[:, t])
                              for t, g in enumerate(got)],
        "prefill_agrees_f32": [agree(full[:, t], full32[:, t])
                               for t in range(len(got))],
        "finite": all(bool(torch.isfinite(g).all()) for g in got),
        "shape": list(got[0].shape)}
    # layer by layer: where the bf16 model leaves its f32 copy, and each
    # layer's decode against its forward on the layer's own inputs
    with torch.no_grad():
        xb, db = rwkv_layers(cfg, params, tokens, prompt, steps)
        xf, df = rwkv_layers(m32.cfg, p32, tokens, prompt, steps)
    res["layers"] = {"bf16_to_f32": [rel_l2(b, f)
                                     for b, f in zip(xb[1:], xf[1:])],
                     "decode_bf16": db, "decode_f32": df}
    del got, full, got32, full32, m32, p32, xb, xf
    release(device)

    if device.type == "cuda":
        with torch.no_grad():
            batch = {"tokens": tokens[:, :prompt]}
            res["prefill_ms"] = cuda_ms(lambda: model.prefill(params, batch),
                                        2)[0]
            _, caches = model.prefill(params, batch)
            cache = model.cache_from_prefill(caches, prompt, prompt + steps)
            tok = tokens[:, prompt:prompt + 1]
            pos = torch.tensor(prompt, device=device)
            res["decode_step_ms"] = cuda_ms(
                lambda: model.decode(params, cache, tok, pos), 10)[0]
            del caches, cache
    del params
    release(device)

    # the serving engine at full size, a burst of equal-length requests
    from repro_torch.serve import Request

    policy = BucketPolicy(batch=buckets[0], seq=buckets[1])
    t0 = time.perf_counter()
    with fault_free("RWKV-6 engine"):
        eng = build_engine(cfg.name, smoke=False, seed=seed + 23,
                           device=device, config=ServeConfig(
                               buckets=policy, mode="continuous",
                               jit_prefill=False))
        res["engine_prewarm_s"] = time.perf_counter() - t0
        rng = torch.Generator(device="cpu").manual_seed(seed + 31)
        reqs = [Request(prompt=torch.randint(
                    1, cfg.vocab, (48 + 16 * i,), generator=rng,
                    dtype=torch.int32).numpy(), max_new_tokens=24)
                for i in range(burst)]
        sync(device)
        t0 = time.perf_counter()
        snap = eng.run([(0.0, r) for r in reqs])
        sync(device)
        wall = time.perf_counter() - t0
    fn = eng._decode
    res["engine"] = {
        "prewarm": eng.metrics.prewarm, "run_s": wall,
        "tokens": sum(len(r.tokens) for r in reqs),
        "decode_step_s": snap["decode_step_s"], "ttft_s": snap["ttft_s"],
        "buckets_used": sorted({b for r in reqs for b in r.decode_buckets}),
        "failed": [r.failed for r in reqs if r.failed],
        "matches": [[m.computation for m in e.report.matches]
                    for e in fn._compiled.values()],
        "detects": fn.stats["detects"],
        "baked": fn.plan_info()["baked"],
        "bake_errors": fn.plan_info()["bake_errors"]}
    # the uncompiled decode teacher-forced at the engine's bucket, from
    # the same prefills, against each stream's next token
    model, params = eng.model, eng.params
    shape = (policy.batch_bucket(len(reqs)),
             policy.seq_bucket(max(r.prompt_len + r.max_new_tokens
                                   for r in reqs)))
    with torch.no_grad():
        cache, firsts = _install(model, params, reqs, shape, device)
        agree = []
        for t in range(min(len(r.tokens) for r in reqs) - 1):
            tok, pos = _step_inputs(reqs, shape[0], t, device)
            logits, cache = model.decode(params, cache, tok, pos)
            agree.append([int(logits[i].argmax()) == r.tokens[t + 1]
                          for i, r in enumerate(reqs)])
    res["engine"].update(first_tokens_agree=firsts, teacher_forced=agree,
                         streams_equal=all(firsts) and all(map(all, agree)),
                         shape=list(shape))
    del eng, model, params
    release(device)
    return res


def check_rwkv_path(res) -> None:
    steps = res["steps"]
    b, f = res["bf16"], res["f32"]
    require(b["finite"] and len(b["rel_l2"]) == steps + 1,
            f"RWKV-6: {steps + 1} finite logits (prefill + {steps} decode "
            f"steps), got {len(b['rel_l2'])}")
    require(f["max_rel_l2"] <= RWKV_F32_RTOL,
            f"RWKV-6 f32: decode after prefill within relative L2 "
            f"{RWKV_F32_RTOL} of the prefill over the longer sequence at "
            f"every step, got {f['max_rel_l2']:.3g}")
    # each layer adds its bf16 rounding to what the layers below left, in
    # the reference too (ROADMAP §3 D3): a layer's decode is held to its
    # forward on its own inputs, the whole decode to the f32 oracle no
    # further than RWKV_BF16_SPREAD times the bf16 prefill is
    lay = res["layers"]
    require(max(lay["decode_bf16"]) <= RWKV_BF16_LAYER_RTOL
            and max(lay["decode_f32"]) <= RWKV_F32_RTOL,
            f"RWKV-6: each layer's decode within relative L2 "
            f"{RWKV_BF16_LAYER_RTOL} (bf16) and {RWKV_F32_RTOL} (f32) of "
            f"its forward on its own inputs, got "
            f"{max(lay['decode_bf16']):.3g} and {max(lay['decode_f32']):.3g}")
    d, p = max(b["decode_to_f32"]), max(b["prefill_to_f32"])
    require(d <= RWKV_BF16_SPREAD * p,
            f"RWKV-6 bf16: decode within {RWKV_BF16_SPREAD}x the bf16 "
            f"prefill's relative L2 from the f32 oracle, got {d:.3g} "
            f"against {p:.3g}")
    e = res["engine"]
    require(not e["failed"] and e["streams_equal"]
            and e["baked"] == e["prewarm"]["n_signatures"],
            f"RWKV-6 engine: every request finishes, every signature bakes "
            f"and each stream equals the uncompiled decode teacher-forced "
            f"at the engine's bucket, got {e}")


def print_rwkv_path(rw) -> None:
    c = rw["config"]
    med = lambda v: sorted(v)[len(v) // 2]
    print(f"RWKV-6 {c['name']} ({c['layers']} layers, d_model "
          f"{c['d_model']}, {c['heads']} heads, d_ff {c['d_ff']}, vocab "
          f"{c['vocab']}): {c['params']} params, initialized in "
          f"{rw['init_s']:.1f}s; prefill {RWKV_BATCH} x {rw['prompt']} "
          f"{_ms(rw.get('prefill_ms'))} ms, decode step "
          f"{_ms(rw.get('decode_step_ms'))} ms (bf16, CUDA events)")
    print(f"RWKV-6 decode after prefill against the prefill over the longer "
          f"sequence, {rw['steps']} steps: f32 relative L2 max "
          f"{rw['f32']['max_rel_l2']:.3g} (median "
          f"{med(rw['f32']['rel_l2']):.3g}; tol {RWKV_F32_RTOL}); bf16 "
          f"argmax agrees at {sum(rw['bf16']['argmax_agree'])} of "
          f"{len(rw['bf16']['argmax_agree'])} steps, relative L2 max "
          f"{max(rw['bf16']['rel_l2']):.3g}; against the f32 oracle: bf16 "
          f"decode max {max(rw['bf16']['decode_to_f32']):.3g} (median "
          f"{med(rw['bf16']['decode_to_f32']):.3g}, argmax agrees at "
          f"{sum(rw['bf16']['decode_agrees_f32'])}), bf16 prefill max "
          f"{max(rw['bf16']['prefill_to_f32']):.3g} (median "
          f"{med(rw['bf16']['prefill_to_f32']):.3g}, argmax agrees at "
          f"{sum(rw['bf16']['prefill_agrees_f32'])}; tol "
          f"{RWKV_BF16_SPREAD}x)")
    lay = rw["layers"]
    print(f"RWKV-6 layer by layer: bf16 residual stream against f32's "
          f"(relative L2) {' '.join(f'{v:.3g}' for v in lay['bf16_to_f32'])}")
    print(f"RWKV-6 each layer's decode against its forward on its own "
          f"inputs, over {rw['steps']} steps: bf16 max "
          f"{max(lay['decode_bf16']):.3g} (median "
          f"{med(lay['decode_bf16']):.3g}; tol {RWKV_BF16_LAYER_RTOL}), f32 "
          f"max {max(lay['decode_f32']):.3g} (tol {RWKV_F32_RTOL})")
    e = rw["engine"]
    print(f"RWKV-6 engine: prewarm {e['prewarm']['baked']}/"
          f"{e['prewarm']['n_signatures']} baked in "
          f"{rw['engine_prewarm_s']:.1f}s; decode-step matches {e['matches']}"
          f" ({e['detects']} detections); burst {e['tokens']} tokens in "
          f"{e['run_s']:.2f}s, decode step p50 "
          f"{1e3 * e['decode_step_s']['p50']:.2f} ms, p99 "
          f"{1e3 * e['decode_step_s']['p99']:.2f} ms, buckets "
          f"{e['buckets_used']}; streams equal to the uncompiled decode "
          f"teacher-forced at {tuple(e['shape'])}: {e['streams_equal']}")


# ---------------------------------------------------------------------------
# Jamba-v0.1 (52 B) at full width: Mamba, attention and MoE served on K4
# ---------------------------------------------------------------------------

# 32 layers are 51.6 B parameters, 103 GB in bf16, more than one card
# holds: two periods are 26,053,599,168 (52.1 GB), one period in f32
# 13,295,237,088 (53.2 GB); a depth stays a multiple of the 8-layer period
# (one period, for the script's time limit)
JAMBA_LAYERS, JAMBA_F32_LAYERS = 8, 8


def jamba_path(seed: int, device, cfg=None, f32_layers: int = JAMBA_F32_LAYERS,
               prompt: int = MAMBA_PROMPT, steps: int = MAMBA_STEPS) -> dict:
    """Jamba served by repro_torch.serve (``serve_path(light=True)``
    without its f32 part, which a model past one period cannot hold beside
    its bf16 copy), then on the same
    parameters (drawn again from the seed): each layer by
    ``mamba_layers`` (bf16, an f32 copy beside, a block at a time) and the
    whole bf16 decode against the bf16 forward over the longer sequence
    (``decode_against_forward``, the forward's MoE the naive dispatch);
    then, the bf16 model freed, the f32 comparison at ``f32_layers``: the
    compiled f32 decode (K4's f32 body) against the naive one, teacher-
    forced on the burst's first two streams at their bucket
    (``compiled_f32``), as the serving result's ``teacher_forced["f32"]``."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    cfg = cfg or get_arch("jamba-v0.1-52b").replace(n_layers=JAMBA_LAYERS)
    t_start = time.perf_counter()

    def progress(what):        # on stderr: where a cut-off run stopped
        print(f"jamba: {what} at {time.perf_counter() - t_start:.1f}s",
              file=sys.stderr, flush=True)

    res = serve_path(seed, device, cfg=cfg, light=True, f32=False)
    release(device)
    progress(f"served, {torch.cuda.memory_reserved(device) / 2**30:.2f} GiB "
             f"reserved, {torch.cuda.mem_get_info(device)[0] / 2**30:.2f} "
             f"GiB free on the card")

    # the serving phase's parameters (its generator and seed)
    model = build_model(cfg.replace(moe_impl="naive",
                                    moe_decode_impl="naive_flat"))
    params = model.init(torch.Generator(device=device).manual_seed(seed + 17),
                        device)
    gen = torch.Generator(device="cpu").manual_seed(seed + 37)
    tokens = torch.randint(1, cfg.vocab, (2, prompt + steps), generator=gen,
                           dtype=torch.int32).to(device)
    t0 = time.perf_counter()
    with torch.no_grad():
        lay = mamba_layers(model.cfg, params, tokens, prompt, steps, f32=True)
    res["mamba_layers"] = {
        "prompt": prompt, "steps": steps,
        "bf16_to_f32": [rel_l2(b, f) for b, f in zip(
            lay["model"]["streams"][1:], lay["f32"]["streams"][1:])],
        "decode_bf16": lay["model"]["decode"],
        "decode_f32": lay["f32"]["decode"],
        "seconds": time.perf_counter() - t0}
    del lay
    release(device)
    progress("layer by layer")
    got, full = decode_against_forward(model, params, tokens, prompt, steps,
                                       device)
    res["decode_vs_forward"] = {
        "rel_l2": [rel_l2(g, full[:, t]) for t, g in enumerate(got)],
        "argmax_agree": [bool(torch.equal(g.argmax(-1), full[:, t].argmax(-1)))
                         for t, g in enumerate(got)],
        "finite": all(bool(torch.isfinite(g).all()) for g in got)}
    del got, full, params, model
    release(device)
    progress("decode against forward")

    # f32 at one period, after the bf16 model is gone
    if device.type == "cuda":
        res["f32_bytes_before"] = torch.cuda.memory_allocated(device)
    from repro_torch.serve import Request

    reqs = [Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                    rid=r.rid) for r in serve_requests(
                        cfg, res["workload_seed"])[:2]]
    for r, stream in zip(reqs, res["streams"]):
        r.tokens = list(stream)
    cfg32 = cfg.replace(n_layers=f32_layers, moe_decode_impl="naive_flat")
    m32 = build_model(cfg32)
    p32 = m32.init(torch.Generator(device=device).manual_seed(seed + 41),
                   device)

    def cast(tree):                      # leaf by leaf: 26 + 53 GB at once
        for k, v in tree.items():        # would not fit
            if isinstance(v, dict):
                cast(v)
            else:
                tree[k] = v.float()

    cast(p32)
    progress("f32 model built")
    t0 = time.perf_counter()
    f32, _ = compiled_f32(m32, p32, reqs,
                          tuple(res["teacher_forced"]["shape"]), device)
    f32.update(layers=f32_layers, params=m32.param_count(),
               seconds=time.perf_counter() - t0)
    res["teacher_forced"]["f32"] = f32
    del p32, m32
    release(device)
    return res


def check_jamba_path(res) -> None:
    check_serve_path(res)
    f = res["teacher_forced"]["f32"]
    require(f["selections"] == ["cuda.gmm"] and f["launches"].get("gmm_f32")
            and not f["launches"].get("gmm"),
            f"Jamba f32: the compiled f32 decode runs K4's f32 body in every "
            f"MoE layer, got {f['selections']} and {f['launches']}")
    lay = res["mamba_layers"]
    n_mamba = res["config"]["layers"] * 7 // 8
    require(len(lay["decode_bf16"]) == len(lay["decode_f32"]) == n_mamba
            and max(lay["decode_bf16"].values()) <= MAMBA_BF16_LAYER_RTOL
            and max(lay["decode_f32"].values()) <= MAMBA_F32_LAYER_RTOL,
            f"Jamba: each of the {n_mamba} Mamba layers' decode within "
            f"relative L2 {MAMBA_BF16_LAYER_RTOL} (bf16) and "
            f"{MAMBA_F32_LAYER_RTOL} (f32) of its forward on its own inputs, "
            f"got {lay['decode_bf16']} and {lay['decode_f32']}")
    require(res["decode_vs_forward"]["finite"],
            "Jamba: the bf16 decode's logits are finite")


def print_jamba_path(jb) -> None:
    tag = "jamba serving"
    print_serve_path(jb, tag=tag)
    f = jb["teacher_forced"]["f32"]
    print(f"{tag} f32 at {f['layers']} layers ({f['params']} params; "
          f"{jb.get('f32_bytes_before')} B allocated before it; another "
          f"draw, teacher-forced on the bf16 streams, so its prefill's first "
          f"tokens need not be theirs): compiled decode via "
          f"{f['selections']}, launches {f['launches']}, {f['seconds']:.1f}s")
    lay = jb["mamba_layers"]
    med = lambda v: sorted(v)[len(v) // 2]
    print(f"{tag} layer by layer ({lay['seconds']:.1f}s): bf16 residual "
          f"stream against f32's (relative L2) "
          f"{' '.join(f'{v:.3g}' for v in lay['bf16_to_f32'])}")
    b, f = list(lay["decode_bf16"].values()), list(lay["decode_f32"].values())
    print(f"{tag} each Mamba layer's decode against its forward on its own "
          f"inputs, {lay['prompt']} + {lay['steps']} steps: bf16 "
          + " ".join(f"{k}:{v:.3g}" for k, v in lay["decode_bf16"].items())
          + f" (max {max(b):.3g}, median {med(b):.3g}; tol "
          f"{MAMBA_BF16_LAYER_RTOL}); f32 max {max(f):.3g} (tol "
          f"{MAMBA_F32_LAYER_RTOL})")
    d = jb["decode_vs_forward"]
    print(f"{tag} whole bf16 decode against the bf16 forward over the longer "
          f"sequence: relative L2 max {max(d['rel_l2']):.3g} (median "
          f"{med(d['rel_l2']):.3g}, first {d['rel_l2'][0]:.3g}), argmax agrees "
          f"at {sum(d['argmax_agree'])} of {len(d['argmax_agree'])} steps")


# ---------------------------------------------------------------------------
# HuBERT-xlarge and InternVL2-2B: stub frontends, at full width and depth
# ---------------------------------------------------------------------------

STUB_BATCH, STUB_SEQ = 2, 512
STUB_ARCHS = ("hubert-xlarge", "internvl2-2b")


def stub_frontend_path(seed: int, device, cfgs=None) -> dict:
    """Each stub-frontend model at full width and depth from ``--seed``:
    one bf16 and one f32 forward over STUB_BATCH x STUB_SEQ precomputed
    embeddings (the logits of every position, their ms by CUDA events and
    the bf16 logits' relative L2 from the f32 ones); whether changing the
    last position's embedding moves the first position's bf16 logits
    (HuBERT attends both ways, InternVL2 causally); for InternVL2 a
    prefill on the embeddings and one decode step of a token through its
    embedding table (``cfgs`` replaces the registered configs).  These
    reach no kernel, nor does the reference."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.models import transformer as T
    from repro_torch.models.spec import tree_map

    out = {}
    for k, cfg in enumerate(cfgs or [get_arch(a) for a in STUB_ARCHS]):
        arch = cfg.name
        model = build_model(cfg)
        params = model.init(
            torch.Generator(device=device).manual_seed(seed + 43 + k), device)
        emb = torch.randn((STUB_BATCH, STUB_SEQ, cfg.d_model),
                          generator=torch.Generator(device=device)
                          .manual_seed(seed + 47 + k), device=device)

        def logits(m, p, e):
            x, _, _ = T.forward(m.cfg, p, {"embeds": e})
            return torch.einsum("bsd,dv->bsv", x.float(), p["unembed"].float())

        r = {"params": model.param_count(), "layers": cfg.n_layers,
             "d_model": cfg.d_model, "head_dim": cfg.resolved_head_dim,
             "causal": cfg.causal}
        with torch.no_grad():
            lb = logits(model, params, emb)
            edited = emb.clone()
            edited[:, -1] += 1.0
            moved = float((logits(model, params, edited)[:, 0] - lb[:, 0])
                          .abs().max())
            r["ms_bf16"] = cuda_ms(lambda: T.forward(
                cfg, params, {"embeds": emb}), 2)[0] \
                if device.type == "cuda" else None
            if cfg.family == "vlm":
                _, caches = model.prefill(params, {"embeds": emb})
                cache = model.cache_from_prefill(caches, STUB_SEQ,
                                                 STUB_SEQ + 1)
                tok = torch.ones((STUB_BATCH, 1), dtype=torch.int32,
                                 device=device)
                dl, _ = model.decode(params, cache, tok,
                                     torch.tensor(STUB_SEQ, device=device))
                r["decode"] = {"shape": list(dl.shape),
                               "finite": bool(torch.isfinite(dl).all())}
                del caches, cache, dl
            m32 = build_model(cfg.replace(param_dtype=torch.float32))
            p32 = tree_map(lambda a: a.float(), params)
            del params
            lf = logits(m32, p32, emb)
            r["ms_f32"] = cuda_ms(lambda: T.forward(
                m32.cfg, p32, {"embeds": emb}), 2)[0] \
                if device.type == "cuda" else None
        r.update(shape=list(lb.shape), rel_l2=rel_l2(lb, lf),
                 finite=bool(torch.isfinite(lb).all()
                             and torch.isfinite(lf).all()),
                 first_moved_by_last=moved)
        out[arch] = r
        del p32, lb, lf, emb, edited
        release(device)
    return out


def check_stub_frontend_path(res) -> None:
    for arch, r in res.items():
        require(r["finite"] and r["shape"][:2] == [STUB_BATCH, STUB_SEQ]
                and (r["first_moved_by_last"] > 0) != r["causal"],
                f"{arch}: finite bf16 and f32 logits of every position, the "
                f"first position's moved by the last embedding only where "
                f"attention runs both ways, got {r}")
        require("decode" not in r or r["decode"]["finite"],
                f"{arch}: a finite decode step after the prefill, got {r}")


def print_stub_frontend_path(res) -> None:
    for arch, r in res.items():
        print(f"stub frontend {arch} ({r['layers']} layers, d_model "
              f"{r['d_model']}, head_dim {r['head_dim']}, "
              f"{'causal' if r['causal'] else 'bidirectional'}): "
              f"{r['params']} params; forward {STUB_BATCH} x {STUB_SEQ} "
              f"embeddings bf16 {_ms(r['ms_bf16'])} ms, f32 "
              f"{_ms(r['ms_f32'])} ms (CUDA events); bf16 logits against "
              f"f32 relative L2 {r['rel_l2']:.3g}; first position moved by "
              f"the last embedding {r['first_moved_by_last']:.3g}; "
              f"finite {r['finite']}"
              + (f"; decode step after the prefill {r['decode']}"
                 if "decode" in r else ""))


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
    return {"name": e["name"], **({"path": e["path"]} if "path" in e else {}),
            "route": "cuda", "source": SOURCES[e["name"]],
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
    ap.add_argument("--train-phase", action="store_true",
                    help=argparse.SUPPRESS)   # the training phase's process
    ap.add_argument("--serve-phase", action="store_true",
                    help=argparse.SUPPRESS)   # the serving phase's process
    ap.add_argument("--serve-granite-phase", action="store_true",
                    help=argparse.SUPPRESS)   # granite-moe's serving process
    ap.add_argument("--serve-jamba-phase", action="store_true",
                    help=argparse.SUPPRESS)   # Jamba's serving process
    ap.add_argument("--dist-phase", action="store_true",
                    help=argparse.SUPPRESS)   # a rank of the mesh phase
    ap.add_argument("--dist-out", type=Path, default=None,
                    help=argparse.SUPPRESS)
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
    if args.train_phase:
        work = tempfile.mkdtemp(prefix="lilac-torch-train-")
        try:
            with fault_free("training"):
                res = train_path(args.seed, torch.device("cuda"), work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print(json.dumps(res))
        return 0
    if args.serve_phase:
        from repro_torch.configs.olmoe_1b_7b import CONFIG as OLMOE
        print(json.dumps(serve_path(
            args.seed, torch.device("cuda"),
            cfg=OLMOE.replace(n_layers=SERVE_LAYERS), jit_prefill=True),
            default=str))
        return 0
    if args.serve_granite_phase:
        from repro_torch.configs.granite_moe_3b_a800m import CONFIG as GRANITE
        print(json.dumps(serve_path(
            args.seed, torch.device("cuda"),
            cfg=GRANITE.replace(n_layers=GRANITE_SERVE_LAYERS), light=True),
            default=str))
        return 0
    if args.dist_phase:
        return dist_phase_main(args.seed, args.dist_out)
    if args.serve_jamba_phase:
        print(json.dumps(jamba_path(args.seed, torch.device("cuda")),
                         default=str))
        return 0
    # the persistent stores (plans, tuner, quarantine) in a directory of
    # this run; no ambient fault plan or shadow rate
    work = tempfile.mkdtemp(prefix="lilac-torch-")
    os.environ["LILAC_TORCH_PLAN_CACHE"] = str(Path(work) / "plans.json")
    os.environ["LILAC_TORCH_QUARANTINE_CACHE"] = str(
        Path(work) / "quarantine.json")
    for k in ("LILAC_TORCH_PLAN_CACHE_DISABLE", "LILAC_TORCH_FAULTS",
              "LILAC_TORCH_FAULTS_SEED", "LILAC_TORCH_SHADOW_RATE",
              "LILAC_TORCH_REQUEST_SHADOW_RATE", "LILAC_TORCH_SERVE_BUCKETS"):
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
    t0 = time.perf_counter()
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
    release(device)
    print(f"SpMV phase {time.perf_counter() - t0:.1f}s")

    # -- the How language's lifecycle: a hook-bearing harness on K1 ---------
    t0 = time.perf_counter()
    with fault_free("lifecycle"):
        lc = lifecycle_path(*mats["npb"], args.seed, device)
    print_lifecycle_path(lc)
    print(f"lifecycle phase {time.perf_counter() - t0:.1f}s")
    check_lifecycle_path(lc)
    staged = next(e for e in ell_rows if e["name"] == "spmv_ell_staged")
    kernels.append(dict(kernel_entry(staged, "main_path", lc["launches"]),
                        path="lifecycle: the hook-bearing harness's CG"))
    record["lifecycle_path"] = lc
    record["npb_packed_tiles"] = t = packed_tiles_of(mats["npb"][0])
    print(f"npb in cuda.bcsr's packed 128x128 tiles: {t['tiles']} tiles, "
          f"{t['nnz']} entries, {t['bytes']} B (dense f32 tiles would take "
          f"{t['dense_tile_bytes']} B)")
    release(device)

    # -- scans: the CG compiled whole as one scan (K1, K2), trace mode ------
    t0 = time.perf_counter()
    with fault_free("scan"):
        sc = scan_path(mats, x_refs, args.seed, device)
    print_scan_path(sc, smi)
    print(f"scan phase {time.perf_counter() - t0:.1f}s")
    check_scan_path(sc)
    rows = {e["name"]: e for e in ell_rows}
    for name, body in SCAN_CASES:
        kernels.append(dict(kernel_entry(rows[body], "main_path",
                                         sc[name]["launches"]),
                            path=f"scan: the {name} CG compiled as one scan"))
    kernels.append(dict(kernel_entry(rows["spmv_ell"], "relu_bias",
                                     sc["trace"]["launches"]),
                        path="scan: the ELL layer's loop in trace mode"))
    record["scan_path"] = sc
    release(device)

    # -- torch.func.vmap over compiled functions (K1, K2, K3) ---------------
    t0 = time.perf_counter()
    with fault_free("vmap"):
        vm = vmap_path(mats, x_refs, args.seed, device)
    print_vmap_path(vm, smi)
    print(f"vmap phase {time.perf_counter() - t0:.1f}s")
    check_vmap_path(vm)
    kernels += vmap_entries(vm)
    record["vmap_path"] = vm
    release(device)

    # -- K1's rows_per_slab variants, the ELL layer in trace mode ------------
    t0 = time.perf_counter()
    with fault_free("slab variants and the ELL layer in trace mode"):
        slabs = slab_variants(mats["npb"][0], args.seed, device)
    print_tune_variants(slabs["variants"], "spmv_ell rows_per_slab",
                        f"tol atol={KERNEL_ATOL} + rtol={KERNEL_RTOL}*|ref|")
    print_trace(slabs["trace"], "ELL layer (npb)")
    check_variants(slabs["variants"], "spmv_ell rows_per_slab")
    check_trace(slabs["trace"], "ELL layer")
    record["slab_variants"] = slabs
    release(device)
    print(f"slab-variant phase {time.perf_counter() - t0:.1f}s")

    # -- host-mode autotune at NPB-C and HPCG, then a warm start ------------
    t0 = time.perf_counter()
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
    print(f"autotune phase {time.perf_counter() - t0:.1f}s")

    # -- executable plans: the CGs replayed from one CUDA graph -------------
    t0 = time.perf_counter()
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
    print(f"plan phase {time.perf_counter() - t0:.1f}s")

    # -- a compiled function inside a user's torch.compile (K1, K4) ---------
    t0 = time.perf_counter()
    with fault_free("user compile"):
        uc = user_compile_path(mats, x_refs["npb"], OLMOE, args.seed, device)
    print_user_compile_path(uc, smi)
    print(f"user-compile phase {time.perf_counter() - t0:.1f}s")
    check_user_compile_path(uc)
    kernels.append(dict(kernel_entry(rows["spmv_ell"], "relu_bias",
                                     uc["ell"]["launches"]["spmv_ell"]),
                        path="user compile: the ELL layer inside "
                             "torch.compile(fullgraph=True)"))
    kernels.append(dict(kernel_entry(
        staged, "main_path", uc["cg"]["launches"]["spmv_ell_staged"]),
        path="user compile: the NPB-C CG step behind a graph break"))
    record["user_compile_path"] = uc
    release(device)

    # -- SpMM and SpMV on BCSR (K3) -----------------------------------------
    t0 = time.perf_counter()
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
    print(f"BCSR phase {time.perf_counter() - t0:.1f}s")

    # -- MoE (K4) ------------------------------------------------------------
    t0 = time.perf_counter()
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
          f"GiB; K4 launches {moe['launches']} under torch.func.vmap, "
          f"{moe['plan_launches']} in the next call on its batched plan "
          f"({moe['plan_hits']} hit, equal to the unplanned call bit for bit "
          f"{moe['plan_equal']}; plans {moe['plans']}) (the "
          f"per-sequence loop it replaced: {moe['loop_launches']}, "
          f"{moe['loop_call_ms']:.3f} ms a block from its plans; equal to "
          f"the loop bit for bit {moe['loop_equal']}, relative L2 "
          f"{moe['rel_to_loop']:.3g})")
    check_moe_path(moe)
    record["moe_path"] = moe
    mb = moe_batched_numbers(OLMOE, p, x, device)
    print(f"vmap gmm gate_up ({x.shape[0]} sequences' {mb['routed_rows']} "
          f"routed rows in Tp {mb['tp']}; alone Tp {mb['solo_tp']}): one "
          f"launch {_ms(mb['ms'])} ms (profiler {_ms(mb['profiler_ms'])} "
          f"ms), the sequences one launch each {_ms(mb['solo_ms'])} ms, "
          f"bound {mb['bound_ms']:.4f} ms by {mb['bound_by']} (share "
          f"{_ms(mb['share'])}), plain {_ms(mb['plain_ms'])} ms; each "
          f"token's row equal to the solo launches' bit for bit: "
          f"{mb['equal_to_solo']}; max|err| vs plain {mb['max_abs_err']:.3g}"
          f" ({smi})")
    require(mb["equal_to_solo"], "vmap gmm: each token's row of the batched "
            "launch equal bit for bit to its sequence's solo launch")
    kernels.append({
        "name": "gmm", "path": f"vmap: moe_block(impl='lilac') over "
        f"{x.shape[0]} sequences, the gate/up product over their tokens",
        "route": "cuda", "source": SOURCES["gmm"], "replaces": REPLACES["gmm"],
        "launches": moe["launches"]["gmm"],
        **{k: mb[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms")}})
    record["moe_batched"] = mb
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
    kernels.append(dict(kernel_entry(gmm, "gate_up",
                                     uc["moe"]["launches"]["gmm"]),
                        path="user compile: the OLMoE block inside "
                             "torch.compile(fullgraph=True)"))
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
    print(f"MoE phase {time.perf_counter() - t0:.1f}s")

    # -- gradients through the kernels --------------------------------------
    t0 = time.perf_counter()
    with fault_free("gradients"):
        gp = grad_path(mats, args.seed, device)
    for key, r in gp.items():
        print(f"gradient {key}: {r}")
    check_grad_path(gp)
    print(f"gradient phase {time.perf_counter() - t0:.1f}s")
    record["grad_path"] = gp
    release(device)

    # -- RWKV-6 1.6B, full width, RWKV_LAYERS deep: a recurrent decode state -
    # (before the containment phase, whose quarantine records stay)
    t0 = time.perf_counter()
    rw = rwkv_path(args.seed, device)
    rw["seconds"] = time.perf_counter() - t0
    print_rwkv_path(rw)
    print(f"RWKV-6 phase {rw['seconds']:.1f}s")
    check_rwkv_path(rw)
    record["rwkv_path"] = rw
    release(device)

    # -- HuBERT-xlarge and InternVL2-2B, full width and depth ---------------
    t0 = time.perf_counter()
    stub = stub_frontend_path(args.seed, device)
    print_stub_frontend_path(stub)
    print(f"stub-frontend phase {time.perf_counter() - t0:.1f}s")
    check_stub_frontend_path(stub)
    record["stub_frontend_path"] = stub
    release(device)

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
          f"{sh['moe']} (the sequences, each with its check, twice, ms)")
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
    # the child phases below need the card: let go of what this process
    # still holds (the module's compiled MoE, whose batched plan keeps its
    # CUDA graph's pool and the tensors it reads in place, and the
    # matrices)
    from repro_torch.models import layers as L

    L._LILAC_MOE.clear()
    del mats, x_refs, x_ref
    release(device)
    print(f"this process holds {torch.cuda.memory_reserved(device) / 2**30:.2f}"
          f" GiB reserved ({torch.cuda.memory_allocated(device) / 2**30:.2f} "
          f"GiB allocated) before the child phases")

    # -- training: OLMoE-1B-7B, full width, TRAIN_LAYERS deep ----------------
    # a process of its own: deterministic algorithms need cuBLAS's
    # workspace fixed before its first call, and the earlier phases' memory
    # is gone
    t0 = time.perf_counter()
    tr = run_warm_start(args.seed, Path(work) / "autotune-train.json",
                        "--train-phase", timeout=900,
                        CUBLAS_WORKSPACE_CONFIG=":4096:8",
                        LILAC_TORCH_QUARANTINE_CACHE=str(
                            Path(work) / "quarantine-train.json"))
    print_train_path(tr)
    check_train_path(tr)
    record["train_path"] = tr
    print(f"training phase {time.perf_counter() - t0:.1f}s")

    # -- serving: OLMoE-1B-7B, full width, SERVE_LAYERS deep -----------------
    # a process of its own: the earlier phases' memory is gone, and cuBLAS's
    # workspace is fixed before its first call, so a row's bits depend on
    # the shapes it runs at and on nothing else
    t0 = time.perf_counter()
    sv = run_warm_start(args.seed, Path(work) / "autotune-serve.json",
                        "--serve-phase", timeout=900,
                        CUBLAS_WORKSPACE_CONFIG=":4096:8",
                        LILAC_TORCH_PLAN_CACHE=str(
                            Path(work) / "plans-serve.json"),
                        LILAC_TORCH_QUARANTINE_CACHE=str(
                            Path(work) / "quarantine-serve.json"))
    print_serve_path(sv)
    check_serve_path(sv)
    kernels += [kernel_entry(e, "model routes", sv["launches"].get("gmm", 0))
                for e in sv["gmm_decode"]]
    record["serve_path"] = sv
    print(f"serving phase {time.perf_counter() - t0:.1f}s")

    # -- serving granite-moe-3b-a800m, full width, depth cut (K4) ------------
    t0 = time.perf_counter()
    gr = run_warm_start(args.seed, Path(work) / "autotune-granite.json",
                        "--serve-granite-phase", timeout=900,
                        CUBLAS_WORKSPACE_CONFIG=":4096:8",
                        LILAC_TORCH_PLAN_CACHE=str(
                            Path(work) / "plans-granite.json"),
                        LILAC_TORCH_QUARANTINE_CACHE=str(
                            Path(work) / "quarantine-granite.json"))
    print_serve_path(gr, tag="granite serving")
    check_serve_path(gr)
    kernels += [kernel_entry(e, "model routes", gr["launches"].get("gmm", 0))
                for e in gr["gmm_decode"]]
    record["granite_serve_path"] = gr
    print(f"granite serving phase {time.perf_counter() - t0:.1f}s")

    # -- Jamba-v0.1 at full width, JAMBA_LAYERS deep (K4 in its MoE layers) --
    t0 = time.perf_counter()
    jb = run_warm_start(args.seed, Path(work) / "autotune-jamba.json",
                        "--serve-jamba-phase", timeout=900,
                        CUBLAS_WORKSPACE_CONFIG=":4096:8",
                        LILAC_TORCH_PLAN_CACHE=str(
                            Path(work) / "plans-jamba.json"),
                        LILAC_TORCH_QUARANTINE_CACHE=str(
                            Path(work) / "quarantine-jamba.json"))
    print_jamba_path(jb)
    check_jamba_path(jb)
    kernels += [kernel_entry(e, "model routes", jb["launches"].get("gmm", 0))
                for e in jb["gmm_decode"]]
    record["jamba_serve_path"] = jb
    print(f"Jamba serving phase {time.perf_counter() - t0:.1f}s")

    # -- distributed training: OLMoE-1B-7B on a (2, 2) mesh, 4 ranks ---------
    t0 = time.perf_counter()
    dr = run_dist_phase(args.seed, work)
    print_dist_path(dr)
    check_dist_path(dr)
    g = dr["ranks"][0]["gmm"]
    kernels.append(dict(kernel_entry(g, "gate_up", sum(
        s["launches"].get("gmm", 0) for r in dr["ranks"] for s in r["steps"])),
        path="distributed training on a (2, 2) mesh: every rank's local "
             "experts (launches summed over the ranks' steps; times on "
             "rank 0's experts)"))
    cells = dr["cells"]
    print_dist_recurrent(dr, cells, smi)
    check_dist_recurrent(dr, cells)
    kernels.append(dict(kernel_entry(
        dr["ranks"][0]["recurrent"]["jamba"]["gmm"], "gate_up", sum(
            r["recurrent"]["jamba"]["launches"].get("gmm", 0)
            for r in dr["ranks"])),
        path="distributed Jamba-v0.1 prefill and decode on a (2, 2) mesh: "
             "every rank's local experts (launches summed over the ranks' "
             "bf16 run; times on rank 0's experts at the prefill)"))
    record["dist_path"], record["dist_dryrun"] = dr, cells
    print(f"distributed phase {time.perf_counter() - t0:.1f}s")

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
