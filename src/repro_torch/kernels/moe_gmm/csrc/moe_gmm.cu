// Group-aligned grouped matmul on Hopper (K4): the MoE expert hot loop.
//
// Replaces the TPU kernel in src/repro/kernels/moe_gmm/kernel.py:
//   gmm_kernel <- gmm_pallas (body _gmm_kernel)
//
// Computes out[i, :] = xs[i, :] @ w[tile_expert[i / tm]] for every row i
// of the (Tp, D) operand, whose rows are grouped by expert and padded to
// whole tm-row tiles, with w (E, D, F): out (Tp, F) in f32, summed in f32
// whatever the storage type.  Called three times per MoE FFN (gate, up,
// down).  Rows of the tail tiles that belong to no group are zeros and
// give zeros, as in the reference.
//
// The Pallas grid (m_tiles, n_tiles, k_tiles) revisits the output block
// over k and steers the weight DMA by the scalar-prefetched tile_expert.
// Here one CTA owns one (row block, column tile) pair: it reads its
// expert from tile_expert itself, walks D in 32-deep chunks staged
// through shared memory (the xs rows and the matching rows of w[e]),
// keeps the sum in registers and stores once.  A row block is one tile,
// or 128 rows of a tile taller than 128, so every row of a CTA has the
// same expert.  Expert ids follow the reference's indexing rule: a
// negative id counts from the end, then the id is clamped into [0, E), so
// no id reads past w.
//
// Bound: at OLMoE's gate/up shapes (32,768 routed rows of 2,048, weights
// 64 x 2,048 x 1,024, bf16) the function moves ~0.54 GB and does 137
// GFLOP: ~0.16 ms at the card's memory rate and ~0.14 ms at its bf16
// tensor-core rate.  This first kernel runs its FMAs on the CUDA cores in
// f32 over the padded Tp rows (40,832 at OLMoE): 171 GFLOP at ~67 TFLOP/s
// is >= 2.6 ms, so it is bound by operations; bf16 mma.sync / wgmma is the
// next step (ROADMAP).  The tiling is the plain SIMT one: 256 threads, an 8x8
// f32 micro-tile each, shared-memory reads that broadcast (A) or run over
// consecutive banks (B), global loads of consecutive addresses.
// Offsets into w (64 x 2,048 x 1,024 = 134 M elements) are 64-bit.
//
// C interface for ctypes: each entry point launches on the given stream
// and returns cudaGetLastError(), so a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;  // rows a CTA covers at most
constexpr int kBN = 128;  // columns a CTA covers at most
constexpr int kBK = 32;   // depth of one shared-memory chunk
constexpr int kTN = 8;
constexpr int kThreadsN = kBN / kTN;         // 16
constexpr int kThreadsM = kThreads / kThreadsN;  // 16
constexpr int kTM = kBM / kThreadsM;         // 8

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// CTA (blockIdx.x, blockIdx.y) computes rows [bx*rb, bx*rb + rb) and
// columns [by*fn, by*fn + fn) of out; rb <= 128 divides tm (or equals it),
// fn <= 128.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gmm_kernel(const T* __restrict__ xs, const T* __restrict__ w,
           const int* __restrict__ tile_expert, float* __restrict__ out,
           int d, int f, int n_experts, int tm, int rb, int fn) {
  __shared__ float As[kBM][kBK + 1];
  __shared__ float Bs[kBK][kBN];

  const int tx = threadIdx.x % kThreadsN;
  const int ty = threadIdx.x / kThreadsN;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rb;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * fn;
  int e = tile_expert[r0 / tm];
  if (e < 0) e += n_experts;
  e = min(max(e, 0), n_experts - 1);
  const T* we = w + static_cast<int64_t>(e) * d * f;
  float acc[kTM][kTN];
#pragma unroll
  for (int m = 0; m < kTM; ++m) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[m][j] = 0.0f;
  }

  for (int k0 = 0; k0 < d; k0 += kBK) {
    for (int s = threadIdx.x; s < kBM * kBK; s += kThreads) {
      const int i = s / kBK;
      const int kk = s % kBK;
      float v = 0.0f;
      if (i < rb && k0 + kk < d) v = to_f32(xs[(r0 + i) * d + k0 + kk]);
      As[i][kk] = v;
    }
    for (int s = threadIdx.x; s < kBK * kBN; s += kThreads) {
      const int kk = s / kBN;
      const int c = s % kBN;
      float v = 0.0f;
      if (k0 + kk < d && c < fn && c0 + c < f) {
        v = to_f32(we[static_cast<int64_t>(k0 + kk) * f + c0 + c]);
      }
      Bs[kk][c] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float av[kTM];
      float bv[kTN];
#pragma unroll
      for (int m = 0; m < kTM; ++m) av[m] = As[ty + m * kThreadsM][kk];
#pragma unroll
      for (int j = 0; j < kTN; ++j) bv[j] = Bs[kk][tx + j * kThreadsN];
#pragma unroll
      for (int m = 0; m < kTM; ++m) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          acc[m][j] = fmaf(av[m], bv[j], acc[m][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < kTM; ++m) {
    const int i = ty + m * kThreadsM;
    if (i >= rb) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = tx + j * kThreadsN;
      if (c >= fn || c0 + c >= f) continue;
      out[(r0 + i) * f + c0 + c] = acc[m][j];
    }
  }
}

template <typename T>
int launch(const void* xs, const void* w, const void* tile_expert, void* out,
           int tp, int d, int f, int n_experts, int tm, int fn,
           void* stream) {
  const int rb = tm < kBM ? tm : kBM;
  const dim3 grid(tp / rb, (f + fn - 1) / fn);
  gmm_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xs), static_cast<const T*>(w),
      static_cast<const int*>(tile_expert), static_cast<float*>(out), d, f,
      n_experts, tm, rb, fn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int gmm_f32(const void* xs, const void* w, const void* tile_expert, void* out,
            int tp, int d, int f, int n_experts, int tm, int fn,
            void* stream) {
  return launch<float>(xs, w, tile_expert, out, tp, d, f, n_experts, tm, fn,
                       stream);
}

int gmm_bf16(const void* xs, const void* w, const void* tile_expert,
             void* out, int tp, int d, int f, int n_experts, int tm, int fn,
             void* stream) {
  return launch<__nv_bfloat16>(xs, w, tile_expert, out, tp, d, f, n_experts,
                               tm, fn, stream);
}

}  // extern "C"
