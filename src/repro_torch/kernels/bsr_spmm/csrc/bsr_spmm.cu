// BCSR SpMM on Hopper (K3), with the fused (+bias) -> relu|silu epilogue
// (K5).
//
// Replaces the TPU kernel in src/repro/kernels/bsr_spmm/kernel.py:
//   bsr_spmm_kernel      <- bsr_spmm_pallas (body _bsr_spmm_kernel)
//   epilogue_inregister  <- kernels/common.py apply_epilogue_inregister
//
// Computes, for block row r and its stored tiles t in
// block_rowptr[r] .. block_rowptr[r+1]:
//   out[r*bm + i, c] = epilogue(sum_t sum_k blocks[t][i][k]
//                                 * dense[block_col[t]*bk + k, c] + bias)
// with a row bias (bias[r*bm + i]) or a column bias (bias[c]), in f32
// whatever the storage type.  Rows of `dense` past its end read as zeros,
// so a caller need not pad it to whole tiles; columns past N and rows past
// out_rows are masked, so nothing is padded on the output side either.
//
// The Pallas grid (n_tiles, nnzb) carries a block row's sum across
// consecutive grid steps in the output block, which relies on the TPU's
// sequential grid.  Hopper blocks run in no order, so here one CTA owns one
// (block row, column tile) pair and loops over the block row's tiles
// itself: the sum stays in registers, the epilogue runs on it, and the
// output is stored once.  No atomics, no second pass.  A block row with no
// tile stores epilogue(0 + bias), so the epilogue always fuses.
//
// Bound: a tile product reads a 128x128 tile and 128 rows of `dense` and
// does 2*128*128*N flops, most of them on zeros at the fill of a sparse
// operator's tiles (1.9 % for HPCG's 27-point stencil).  At N = 128 the
// CTA is bound by f32 FMAs on the CUDA cores; at N = 1 (SpMV) by the bytes
// of the tiles.  The design is the plain SIMT tiling that serves both:
//   * the CTA stages a 128 x 32 chunk of the tile and the matching 32 x BN
//     rows of `dense` through shared memory (f32, ~33 KB), loaded by
//     consecutive threads from consecutive addresses;
//   * each of the 256 threads keeps a TM x TN micro-tile of the sum in
//     registers (8 x 8 at BN = 128; 4 x 1 at BN = 8, the width taken for
//     N <= 8, so an SpMV does not compute 127 empty columns);
//   * threads of a warp read one shared A element (a broadcast) and
//     consecutive B elements, so neither read conflicts on banks.
// Tensor cores (mma.sync / wgmma) are later work.
//
// C interface for ctypes: each entry point launches on the given stream
// and returns cudaGetLastError(), so a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;  // rows a CTA covers; a tile's bm is at most this
constexpr int kBK = 32;   // depth of one shared-memory chunk

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// K5: (+bias) -> relu | silu, on the accumulator in a register.
// epilogue: 0 = bias only (or nothing), 1 = relu, 2 = silu.
__device__ __forceinline__ float epilogue_inregister(float acc, float bias,
                                                     int epilogue) {
  acc += bias;
  if (epilogue == 1) {
    acc = fmaxf(acc, 0.0f);
  } else if (epilogue == 2) {
    acc = acc / (1.0f + expf(-acc));
  }
  return acc;
}

// bias_kind: 0 = none, 1 = row (bias[row]), 2 = column (bias[col]).
template <int BN, int TN, typename T>
__global__ void __launch_bounds__(kThreads)
bsr_spmm_kernel(const T* __restrict__ blocks, const int* __restrict__ block_col,
                const int* __restrict__ block_rowptr,
                const T* __restrict__ dense, const float* __restrict__ bias,
                float* __restrict__ out, int bm, int bk, int kdim, int n,
                int out_rows, int bias_kind, int epilogue) {
  constexpr int kThreadsN = BN / TN;
  constexpr int kThreadsM = kThreads / kThreadsN;
  constexpr int TM = kBM / kThreadsM;
  __shared__ float As[kBM][kBK + 1];
  __shared__ float Bs[kBK][BN];

  const int tx = threadIdx.x % kThreadsN;
  const int ty = threadIdx.x / kThreadsN;
  const int64_t br = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  float acc[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[m][j] = 0.0f;
  }

  const int first = block_rowptr[br];
  const int last = block_rowptr[br + 1];
  for (int t = first; t < last; ++t) {
    const T* a = blocks + static_cast<int64_t>(t) * bm * bk;
    const int64_t krow0 = static_cast<int64_t>(block_col[t]) * bk;
    for (int k0 = 0; k0 < bk; k0 += kBK) {
      for (int e = threadIdx.x; e < kBM * kBK; e += kThreads) {
        const int i = e / kBK;
        const int kk = e % kBK;
        float v = 0.0f;
        if (i < bm && k0 + kk < bk) {
          v = to_f32(a[static_cast<int64_t>(i) * bk + k0 + kk]);
        }
        As[i][kk] = v;
      }
      for (int e = threadIdx.x; e < kBK * BN; e += kThreads) {
        const int kk = e / BN;
        const int c = e % BN;
        const int64_t r = krow0 + k0 + kk;
        float v = 0.0f;
        if (k0 + kk < bk && r < kdim && n0 + c < n) {
          v = to_f32(dense[r * n + n0 + c]);
        }
        Bs[kk][c] = v;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kBK; ++kk) {
        float av[TM];
        float bv[TN];
#pragma unroll
        for (int m = 0; m < TM; ++m) av[m] = As[ty + m * kThreadsM][kk];
#pragma unroll
        for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx + j * kThreadsN];
#pragma unroll
        for (int m = 0; m < TM; ++m) {
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            acc[m][j] = fmaf(av[m], bv[j], acc[m][j]);
          }
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int i = ty + m * kThreadsM;
    const int64_t row = br * bm + i;
    if (i >= bm || row >= out_rows) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx + j * kThreadsN;
      if (col >= n) continue;
      const float b = bias_kind == 1 ? bias[row]
                      : bias_kind == 2 ? bias[col] : 0.0f;
      out[row * n + col] = epilogue_inregister(acc[m][j], b, epilogue);
    }
  }
}

template <int BN, int TN, typename T>
int launch_tiled(const void* blocks, const void* block_col,
                 const void* block_rowptr, const void* dense,
                 const void* bias, void* out, int bm, int bk, int kdim, int n,
                 int out_rows, int bias_kind, int epilogue, void* stream) {
  const dim3 grid((out_rows + bm - 1) / bm, (n + BN - 1) / BN);
  bsr_spmm_kernel<BN, TN, T><<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(blocks), static_cast<const int*>(block_col),
      static_cast<const int*>(block_rowptr), static_cast<const T*>(dense),
      static_cast<const float*>(bias), static_cast<float*>(out), bm, bk,
      kdim, n, out_rows, bias_kind, epilogue);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* blocks, const void* block_col, const void* block_rowptr,
           const void* dense, const void* bias, void* out, int bm, int bk,
           int kdim, int n, int out_rows, int bias_kind, int epilogue,
           void* stream) {
  if (n <= 8) {
    return launch_tiled<8, 1, T>(blocks, block_col, block_rowptr, dense, bias,
                                 out, bm, bk, kdim, n, out_rows, bias_kind,
                                 epilogue, stream);
  }
  return launch_tiled<128, 8, T>(blocks, block_col, block_rowptr, dense, bias,
                                 out, bm, bk, kdim, n, out_rows, bias_kind,
                                 epilogue, stream);
}

}  // namespace

extern "C" {

int bsr_spmm_f32(const void* blocks, const void* block_col,
                 const void* block_rowptr, const void* dense, const void* bias,
                 void* out, int bm, int bk, int kdim, int n, int out_rows,
                 int bias_kind, int epilogue, void* stream) {
  return launch<float>(blocks, block_col, block_rowptr, dense, bias, out, bm,
                       bk, kdim, n, out_rows, bias_kind, epilogue, stream);
}

int bsr_spmm_bf16(const void* blocks, const void* block_col,
                  const void* block_rowptr, const void* dense,
                  const void* bias, void* out, int bm, int bk, int kdim,
                  int n, int out_rows, int bias_kind, int epilogue,
                  void* stream) {
  return launch<__nv_bfloat16>(blocks, block_col, block_rowptr, dense, bias,
                               out, bm, bk, kdim, n, out_rows, bias_kind,
                               epilogue, stream);
}

}  // extern "C"
