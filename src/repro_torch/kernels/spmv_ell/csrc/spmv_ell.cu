// ELL SpMV on Hopper: the resident kernel (K1) and the column-windowed
// kernel (K2), with the fused (+bias) -> relu|silu epilogue (K5).
//
// Replaces the TPU kernels in src/repro/kernels/spmv_ell/kernel.py:
//   spmv_ell_kernel          <- spmv_ell_pallas (body _spmv_ell_kernel)
//   spmv_ell_windowed_kernel <- spmv_ell_windowed_pallas
//                               (body _spmv_ell_windowed_kernel)
//   epilogue_inregister      <- kernels/common.py apply_epilogue_inregister
//
// Computes out[o(i)] = epilogue(sum_j val[i,j] * vec[col[i,j]] + bias[o(i)])
// with o(i) = perm[i] when a row permutation is given (the JDS sort of a
// marshaled ELL: the un-permuting scatter is the kernel's own store), else
// o(i) = i.  Accumulation is in f32 whatever the storage type.
//
// Bound: the kernel reads every ELL slot once, val and col, plus the vector
// and writes one f32 a row: bytes = R*W*(4+4) + V*4 + R*4 (+ R*4 bias, + R*4
// perm), against 2*R*W flops, so at 3.35 TB/s it is bound by bytes by two
// orders of magnitude.  K1's design serves that bound and nothing else:
//   * one warp owns a row, so its lanes read val and col in consecutive
//     128-byte lines (coalesced), and no row's sum is ever split across
//     warps or blocks: no atomics and no second pass;
//   * the gather vec[col] goes through L1/L2; the NPB-sized vector (0.6 MB)
//     sits in L2, as does HPCG's (4.5 MB);
//   * the sum is reduced by warp shuffles and the epilogue runs in
//     registers before the single store, so no output-sized intermediate
//     goes to memory.
//
// K2 reads the slab-compacted column-window layout of
// sparse/formats.py:ell_windows (SELL-32 per window): a 32-row slab keeps
// only the windows its rows touch, as segments whose slots are
// column-major (slot k of row i at seg_offset[s] + 32*k + i), with 16-bit
// window-local column ids.  At HPCG-104^3 that is 1.33 segments a slab and
// 0.23 GB; padding every row to all 18 windows would take 5.2 GB.  One warp
// owns a slab and a lane owns a row: the warp reads a slot's val (128
// bytes in f32) and col (64 bytes) in one line each, the sum stays in the
// lane's register
// across the slab's segments, and K5 runs on it before the one store.  The
// TPU grid order (windows accumulate in the output block across grid
// steps) does not carry over: the warp loops over its slab's segments.
//
// C interface for ctypes: each entry point launches on the given stream
// and returns cudaGetLastError(), so a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps a block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// K5: (+bias) -> relu | silu, on the accumulator in a register.
// epilogue: 0 = bias only (or nothing), 1 = relu, 2 = silu.
__device__ __forceinline__ float epilogue_inregister(float acc,
                                                     const float* bias,
                                                     int64_t orow,
                                                     int epilogue) {
  if (bias != nullptr) acc += bias[orow];
  if (epilogue == 1) {
    acc = fmaxf(acc, 0.0f);
  } else if (epilogue == 2) {
    acc = acc / (1.0f + expf(-acc));
  }
  return acc;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, offset);
  }
  return v;
}

// Sum of val[k] * vec[col[k]] over k = lane, lane+32, ... < width.
template <typename T>
__device__ __forceinline__ float lane_dot(const T* __restrict__ val,
                                          const int* __restrict__ col,
                                          const T* __restrict__ vec,
                                          int width, int lane) {
  float acc = 0.0f;
#pragma unroll 4
  for (int k = lane; k < width; k += 32) {
    acc += to_f32(val[k]) * to_f32(vec[col[k]]);
  }
  return acc;
}

__device__ __forceinline__ void store_row(float acc, int64_t row,
                                          const float* __restrict__ bias,
                                          const int* __restrict__ perm,
                                          float* __restrict__ out,
                                          int epilogue) {
  const int64_t orow = perm != nullptr ? perm[row] : row;
  out[orow] = epilogue_inregister(acc, bias, orow, epilogue);
}

constexpr int kSlab = 32;  // rows of a K2 slab: one warp, a lane a row

__device__ __forceinline__ int64_t slab_end(int64_t first, int rows_per_slab,
                                            int rows) {
  const int64_t end = first + rows_per_slab;
  return end < rows ? end : rows;
}

// K1: val/col (rows, width); the whole vector is addressable.  A block
// covers rows_per_slab rows; its warps take them in turn.
template <typename T>
__global__ void __launch_bounds__(kThreads)
spmv_ell_kernel(const T* __restrict__ val, const int* __restrict__ col,
                const T* __restrict__ vec, const float* __restrict__ bias,
                const int* __restrict__ perm, float* __restrict__ out,
                int rows, int width, int rows_per_slab, int epilogue) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * rows_per_slab;
  const int64_t last = slab_end(first, rows_per_slab, rows);
  for (int64_t row = first + warp; row < last; row += kThreads / 32) {
    const int64_t base = row * width;
    float acc = warp_sum(lane_dot(val + base, col + base, vec, width, lane));
    if (lane == 0) store_row(acc, row, bias, perm, out, epilogue);
  }
}

// K2: warp b of the grid owns slab b, lane i its row 32*b + i.  A slab
// with no segment stores epilogue(0 + bias); lanes past `rows` (the ragged
// last slab) read zero padding and store nothing.
template <typename T>
__global__ void __launch_bounds__(kThreads)
spmv_ell_windowed_kernel(const T* __restrict__ val,
                         const uint16_t* __restrict__ col,
                         const int* __restrict__ seg_ptr,
                         const int* __restrict__ seg_window,
                         const int64_t* __restrict__ seg_offset,
                         const T* __restrict__ vec,
                         const float* __restrict__ bias,
                         const int* __restrict__ perm,
                         float* __restrict__ out, int rows, int n_slabs,
                         int window, int epilogue) {
  const int lane = threadIdx.x & 31;
  const int64_t slab =
      static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  if (slab >= n_slabs) return;
  float acc = 0.0f;
  const int s_end = seg_ptr[slab + 1];
  for (int s = seg_ptr[slab]; s < s_end; ++s) {
    const T* v = vec + static_cast<int64_t>(seg_window[s]) * window;
    const int64_t last = seg_offset[s + 1];
#pragma unroll 4
    for (int64_t k = seg_offset[s] + lane; k < last; k += kSlab) {
      acc += to_f32(val[k]) * to_f32(v[col[k]]);
    }
  }
  const int64_t row = slab * kSlab + lane;
  if (row < rows) store_row(acc, row, bias, perm, out, epilogue);
}

inline unsigned int blocks_for(int rows, int rows_per_slab) {
  return static_cast<unsigned int>((static_cast<int64_t>(rows)
                                    + rows_per_slab - 1) / rows_per_slab);
}

template <typename T>
int launch_resident(const void* val, const void* col, const void* vec,
                    const void* bias, const void* perm, void* out, int rows,
                    int width, int rows_per_slab, int epilogue,
                    void* stream) {
  spmv_ell_kernel<T><<<blocks_for(rows, rows_per_slab), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(val), static_cast<const int*>(col),
      static_cast<const T*>(vec), static_cast<const float*>(bias),
      static_cast<const int*>(perm), static_cast<float*>(out), rows, width,
      rows_per_slab, epilogue);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_windowed(const void* val, const void* col, const void* seg_ptr,
                    const void* seg_window, const void* seg_offset,
                    const void* vec, const void* bias, const void* perm,
                    void* out, int rows, int n_slabs, int window,
                    int epilogue, void* stream) {
  spmv_ell_windowed_kernel<T><<<blocks_for(n_slabs, kThreads / 32), kThreads,
                                0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(val), static_cast<const uint16_t*>(col),
      static_cast<const int*>(seg_ptr), static_cast<const int*>(seg_window),
      static_cast<const int64_t*>(seg_offset), static_cast<const T*>(vec),
      static_cast<const float*>(bias), static_cast<const int*>(perm),
      static_cast<float*>(out), rows, n_slabs, window, epilogue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int spmv_ell_f32(const void* val, const void* col, const void* vec,
                 const void* bias, const void* perm, void* out, int rows,
                 int width, int rows_per_slab, int epilogue, void* stream) {
  return launch_resident<float>(val, col, vec, bias, perm, out, rows, width,
                                rows_per_slab, epilogue, stream);
}

int spmv_ell_bf16(const void* val, const void* col, const void* vec,
                  const void* bias, const void* perm, void* out, int rows,
                  int width, int rows_per_slab, int epilogue, void* stream) {
  return launch_resident<__nv_bfloat16>(val, col, vec, bias, perm, out, rows,
                                        width, rows_per_slab, epilogue,
                                        stream);
}

int spmv_ell_windowed_f32(const void* val, const void* col,
                          const void* seg_ptr, const void* seg_window,
                          const void* seg_offset, const void* vec,
                          const void* bias, const void* perm, void* out,
                          int rows, int n_slabs, int window, int epilogue,
                          void* stream) {
  return launch_windowed<float>(val, col, seg_ptr, seg_window, seg_offset,
                                vec, bias, perm, out, rows, n_slabs, window,
                                epilogue, stream);
}

int spmv_ell_windowed_bf16(const void* val, const void* col,
                           const void* seg_ptr, const void* seg_window,
                           const void* seg_offset, const void* vec,
                           const void* bias, const void* perm, void* out,
                           int rows, int n_slabs, int window, int epilogue,
                           void* stream) {
  return launch_windowed<__nv_bfloat16>(val, col, seg_ptr, seg_window,
                                        seg_offset, vec, bias, perm, out,
                                        rows, n_slabs, window, epilogue,
                                        stream);
}

}  // extern "C"
