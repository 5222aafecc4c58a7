// ELL SpMV on Hopper: K1 (vector within RESIDENT_VEC_LIMIT) in two
// bodies and the column-windowed kernel K2, with the fused
// (+bias) -> relu|silu epilogue (K5).
//
// Replaces the TPU kernels in src/repro/kernels/spmv_ell/kernel.py:
//   spmv_ell_staged_kernel   <- spmv_ell_pallas (body _spmv_ell_kernel), on
//                               the marshaled path
//   spmv_ell_kernel          <- spmv_ell_pallas, on a user's ELL/JDS arrays
//   spmv_ell_windowed_kernel <- spmv_ell_windowed_pallas
//                               (body _spmv_ell_windowed_kernel)
//   epilogue_inregister      <- kernels/common.py apply_epilogue_inregister
//
// Computes out[o(i)] = epilogue(sum_j val[i,j] * vec[col[i,j]] + bias[o(i)])
// with o(i) = perm[i] when a row permutation is given (the JDS sort of a
// marshaled ELL: the un-permuting scatter is the kernel's own store), else
// o(i) = i.  Accumulation is in f32 whatever the storage type.
//
// Bound: every stored entry is read once, a value and a column id, plus
// the vector, and one f32 is written a row; 2 flops an entry, so each body
// is bound by bytes by two orders of magnitude.  What a body can spend
// above that bound is padding (slots that hold no entry) and the gathers
// vec[col], each a 32-byte L2 sector for 4 bytes when the vector is read
// from memory.
//
// The staged body (K1 on the marshaled path) keeps the Pallas kernel's
// idea, the vector resident on chip: its layout is
// sparse/formats.py:ell_windows with a window that fits shared memory
// (50,000 columns at NAS CG class C: 3 windows, 0.28 GB against 0.46 GB of
// lane-128 ELL slots).  The CTAs are about one per SM (the window takes
// most of the SM's shared memory), each owning a contiguous range of
// 32-row slabs.  The loop over windows is the outer loop: the CTA stages
// vec[w*W, (w+1)*W) into shared memory (cp.async, 16-byte chunks), then
// its warps walk their slabs' segments for window w, a lane a row,
// gathering from shared memory; each row's partial sum stays in a register
// across windows.  To keep the 32 warps evenly loaded, a slab is split
// into `parts` work items (slots k = p, p+parts, ... of every segment),
// dealt to the warps in turn; at the end the parts of each row are added
// in shared memory in a fixed order, and K5 and the un-permuting store run.
// Every CTA reads the whole vector once from L2 (132 x 0.6 MB at NPB-C).
//
// The direct body (K1 on a user's ELL/JDS arrays, which change every call
// and so are never repacked) reads every slot, padding included: 8 bytes
// a slot (0.46 GB at NPB-C's lane-128 ELL, 150,000 rows of 384 slots,
// 0.138 ms at the memory's rate), and gathers vec[col] for each.  What
// bounds it is those gathers: at random columns each one that misses on
// the SM is its own 32-byte L2 sector, and the vector (600 KB at NPB-C)
// is larger than an SM's 256 KB of L1 and shared memory.  With every
// column id set to 0 the body streams its slots in ~0.16 ms; with the
// real ids it takes ~0.25 ms (tools/k1_k4_probe.py; NVIDIA H100 80GB
// HBM3, 700 W).  The design:
//   * one CTA an SM (1,024 threads); slab b of rows_per_slab rows goes to
//     CTA b % grid, whose half-warps take its rows in turn: two rows in
//     flight a warp;
//   * a half-warp reads a row 16 bytes a lane (4 f32 or 8 bf16 slots and
//     their col ids), four steps in flight, and sums it in a fixed order
//     (each lane its slots in turn, then a shuffle tree), so a row's bits
//     depend on nothing but the row;
//   * val and col stream past L1 (ld.global.nc.L1::no_allocate), and the
//     kernel prefers no shared-memory carve-out beyond what it asks for,
//     so L1 keeps what it can of the vector for the gathers;
//   * each CTA first stages the vector's first elements in shared memory
//     (up to 192 KB; fewer for a small matrix, for which the copy would
//     cost more than it saves), where a gather costs a shared-memory load
//     and no 32-byte sector: densely packed, the prefix holds more of the
//     vector than the same bytes of L1, whose lines the random gathers
//     fill a sector at a time.  Keeping the whole vector in the shared
//     memory of a 3-CTA cluster (distributed shared memory) was tried and
//     was slower;
//   * widths that are not a multiple of the 16-byte step, and rows that
//     do not start 16-byte aligned, take the same body with scalar loads.
// Every slot's col is read and gathered, padding included: 0 * vec[col]
// is NaN where vec[col] is inf or NaN, as in the plain version.  (Skipping
// the slots of value 0 behind a pass that proves the vector finite is
// exact, but saved only ~3 % at NPB-C for a second launch and scratch.)
//
// K2 reads the slab-compacted column-window layout of
// sparse/formats.py:ell_windows (SELL-32 per window) at windows of 65,536:
// a 32-row slab keeps only the windows its rows touch, as segments whose
// slots are column-major (slot k of row i at seg_offset[s] + 32*k + i),
// with 16-bit window-local column ids.  At HPCG-104^3 that is 1.33
// segments a slab and 0.23 GB; padding every row to all 18 windows would
// take 5.2 GB.  One warp owns a slab and a lane owns a row: the warp reads
// a slot's val (128 bytes in f32) and col (64 bytes) in one line each, the
// sum stays in the lane's register across the slab's segments, and K5 runs
// on it before the one store.  The TPU grid order (windows accumulate in
// the output block across grid steps) does not carry over: the warp loops
// over its slab's segments.
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

__device__ __forceinline__ void store_row(float acc, int64_t row,
                                          const float* __restrict__ bias,
                                          const int* __restrict__ perm,
                                          float* __restrict__ out,
                                          int epilogue) {
  const int64_t orow = perm != nullptr ? perm[row] : row;
  out[orow] = epilogue_inregister(acc, bias, orow, epilogue);
}

constexpr int kSlab = 32;  // rows of a K2 slab: one warp, a lane a row

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

constexpr int kStagedWarps = 32;  // staged body: 1024 threads, a CTA an SM
constexpr int kMaxItems = 8;      // work items (slab parts) a warp holds
constexpr int kMaxParts = 8;      // parts a slab splits into (divides 8)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

// Stage vec[c0, c0+len) into vs: 16-byte cp.async chunks where the source
// is aligned, element by element otherwise; then wait and sync.
template <typename T>
__device__ __forceinline__ void stage_window(T* vs, const T* __restrict__ src,
                                             int len) {
  constexpr int kEpc = 16 / sizeof(T);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    done = len / kEpc * kEpc;
    for (int e = threadIdx.x * kEpc; e < done; e += blockDim.x * kEpc) {
      cp_async16(vs + e, src + e);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int e = done + threadIdx.x; e < len; e += blockDim.x) vs[e] = src[e];
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// K1, staged: CTA c owns slabs [c*per_cta, (c+1)*per_cta); work item it of
// the CTA is part (it % parts) of its slab (it / parts), and warp w holds
// items w, w+32, ... (at most kMaxItems).  A slab's segments come in window
// order, so each item keeps a cursor into them.
template <typename T>
__global__ void __launch_bounds__(kStagedWarps * 32, 1)
spmv_ell_staged_kernel(const T* __restrict__ val,
                       const uint16_t* __restrict__ col,
                       const int* __restrict__ seg_ptr,
                       const int* __restrict__ seg_window,
                       const int64_t* __restrict__ seg_offset,
                       const T* __restrict__ vec,
                       const float* __restrict__ bias,
                       const int* __restrict__ perm, float* __restrict__ out,
                       int rows, int cols, int n_slabs, int window,
                       int per_cta, int parts, int epilogue) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* vs = reinterpret_cast<T*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slab0 = blockIdx.x * per_cta;
  const int slab1 = min(n_slabs, slab0 + per_cta);
  const int items = (slab1 - slab0) * parts;
  const int n_windows = (cols + window - 1) / window;

  float acc[kMaxItems];
  int cur[kMaxItems];  // the item's next segment; its slab's end is read
                       // when needed, to spare registers
#pragma unroll
  for (int j = 0; j < kMaxItems; ++j) {
    const int it = warp + j * kStagedWarps;
    acc[j] = 0.0f;
    cur[j] = it < items ? seg_ptr[slab0 + it / parts] : 0;
  }
  for (int w = 0; w < n_windows; ++w) {
    const int64_t c0 = static_cast<int64_t>(w) * window;
    const int64_t rest = cols - c0;
    __syncthreads();  // every gather from the previous window is done
    stage_window(vs, vec + c0, static_cast<int>(rest < window ? rest : window));
#pragma unroll
    for (int j = 0; j < kMaxItems; ++j) {
      const int it = warp + j * kStagedWarps;
      if (it < items && cur[j] < seg_ptr[slab0 + it / parts + 1]
          && seg_window[cur[j]] == w) {
        const int s = cur[j]++;
        const int part = it % parts;
        const int64_t last = seg_offset[s + 1];
        float a = acc[j];
#pragma unroll 4
        for (int64_t k = seg_offset[s] + part * kSlab + lane; k < last;
             k += parts * kSlab) {
          a += to_f32(val[k]) * to_f32(vs[col[k]]);
        }
        acc[j] = a;
      }
    }
  }
  // add the parts of each row in a fixed order, then K5 and the store
  __syncthreads();
  float* part_sum = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int j = 0; j < kMaxItems; ++j) {
    const int it = warp + j * kStagedWarps;
    if (it < items) part_sum[it * kSlab + lane] = acc[j];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < (slab1 - slab0) * kSlab; e += blockDim.x) {
    const int b = e / kSlab;
    const int i = e % kSlab;
    float sum = 0.0f;
    for (int p = 0; p < parts; ++p) sum += part_sum[(b * parts + p) * kSlab + i];
    const int64_t row = static_cast<int64_t>(slab0 + b) * kSlab + i;
    if (row < rows) store_row(sum, row, bias, perm, out, epilogue);
  }
}

// K1, direct: the user's val/col (rows, width) and the whole vector.
constexpr int kDirectThreads = 1024;  // one CTA an SM: 64 half-warps
// The most of the vector a CTA stages: the rest of the SM's 256 KB stays
// L1 for the other gathers (past 192 KB, L1 grows too small for them and
// NPB-C slows again).
constexpr int kDirectStageBytes = 192 * 1024;
constexpr int kStageShare = 4;  // stage at most 1/4 of a CTA's slots

// Streaming loads of val and col: read once, so they do not allocate in L1,
// which keeps it for the vector.
__device__ __forceinline__ uint4 ld_stream16(const void* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

__device__ __forceinline__ float ld_stream(const float* p) {
  float r;
  asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(r) : "l"(p));
  return r;
}

__device__ __forceinline__ float ld_stream(const __nv_bfloat16* p) {
  unsigned short r;
  asm("ld.global.nc.L1::no_allocate.b16 %0, [%1];" : "=h"(r) : "l"(p));
  return __uint_as_float(static_cast<uint32_t>(r) << 16);
}

__device__ __forceinline__ int ld_stream(const int* p) {
  int r;
  asm("ld.global.nc.L1::no_allocate.b32 %0, [%1];" : "=r"(r) : "l"(p));
  return r;
}

// Element q of the 16 bytes w as f32 (4 f32 or 8 bf16 values).
__device__ __forceinline__ float element(const uint32_t (&w)[4], int q,
                                         float) {
  return __uint_as_float(w[q]);
}
__device__ __forceinline__ float element(const uint32_t (&w)[4], int q,
                                         __nv_bfloat16) {
  const uint32_t x = w[q >> 1];
  return __uint_as_float(q & 1 ? x & 0xffff0000u : x << 16);
}

__device__ __forceinline__ float ld_vec(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld_vec(const __nv_bfloat16* p) {
  const unsigned short x = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

// vec[c]: from the prefix staged in shared memory, else through L1.
template <typename T>
__device__ __forceinline__ float gather(const T* vs, const T* vec, int c,
                                        int stage) {
  if (c < stage) return to_f32(vs[c]);
  return ld_vec(vec + c);
}

// A row's sum over its slots, by the 16 lanes of a half-warp: lane hl
// adds its slots in order into one f32, then the 16 partial sums meet in a
// fixed shuffle tree.  kVec: slots [16*kQ*j + kQ*hl, +kQ) for j = 0, 1, ...
// (16-byte loads: kQ = 4 f32 or 8 bf16 values, their col ids in one or
// two); otherwise slots hl, hl + 16, ... one by one.
template <typename T, bool kVec>
__device__ __forceinline__ float row_sum(const T* __restrict__ vrow,
                                         const int* __restrict__ crow,
                                         const T* vs, const T* vec, int width,
                                         int stage, int hl) {
  float acc = 0.0f;
  if (kVec) {
    constexpr int kQ = 16 / sizeof(T);
#pragma unroll 4
    for (int k = hl * kQ; k < width; k += 16 * kQ) {
      const uint4 v4 = ld_stream16(vrow + k);
      const uint32_t v[4] = {v4.x, v4.y, v4.z, v4.w};
      int c[kQ];
#pragma unroll
      for (int j = 0; j < kQ / 4; ++j) {
        const uint4 c4 = ld_stream16(crow + k + 4 * j);
        c[4 * j] = c4.x;
        c[4 * j + 1] = c4.y;
        c[4 * j + 2] = c4.z;
        c[4 * j + 3] = c4.w;
      }
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        acc = fmaf(element(v, q, T()), gather(vs, vec, c[q], stage), acc);
      }
    }
  } else {
#pragma unroll 4
    for (int k = hl; k < width; k += 16) {
      acc = fmaf(ld_stream(vrow + k),
                 gather(vs, vec, ld_stream(crow + k), stage), acc);
    }
  }
  const unsigned mask = 0xffffu << (threadIdx.x & 16);
#pragma unroll
  for (int offset = 8; offset > 0; offset >>= 1) {
    acc += __shfl_xor_sync(mask, acc, offset);
  }
  return acc;
}

// Slab b (rows [b*rows_per_slab, (b+1)*rows_per_slab)) belongs to CTA
// b % gridDim.x; a CTA's rows, slab after slab, go to its half-warps in
// turn.  vec[0, stage) is first staged in shared memory.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kDirectThreads, 1)
spmv_ell_kernel(const T* __restrict__ val, const int* __restrict__ col,
                const T* __restrict__ vec, const float* __restrict__ bias,
                const int* __restrict__ perm, float* __restrict__ out,
                int rows, int width, int rows_per_slab, int stage,
                int epilogue) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* vs = reinterpret_cast<T*>(smem_raw);
  if (stage > 0) stage_window(vs, vec, stage);
  const int hl = threadIdx.x & 15;
  for (int64_t t = threadIdx.x >> 4;; t += kDirectThreads / 16) {
    const int64_t row =
        (blockIdx.x + t / rows_per_slab * gridDim.x) * rows_per_slab +
        t % rows_per_slab;
    if (row >= rows) break;  // a CTA's rows only grow with t
    const int64_t base = row * width;
    const float acc = row_sum<T, kVec>(val + base, col + base, vs, vec,
                                       width, stage, hl);
    if (hl == 0) store_row(acc, row, bias, perm, out, epilogue);
  }
}

inline int sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  }
  return static_cast<int>(err);
}

inline unsigned int blocks_for(int rows, int rows_per_slab) {
  return static_cast<unsigned int>((static_cast<int64_t>(rows)
                                    + rows_per_slab - 1) / rows_per_slab);
}

template <typename T, bool kVec>
int launch_direct_body(const void* val, const void* col, const void* vec,
                       const void* bias, const void* perm, void* out, int rows,
                       int width, int rows_per_slab, int epilogue, int stage,
                       int grid, void* stream) {
  const int smem = stage * static_cast<int>(sizeof(T));
  static int attribute_bytes = -1;
  if (smem > attribute_bytes) {
    cudaError_t err = cudaFuncSetAttribute(
        spmv_ell_kernel<T, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err == cudaSuccess && attribute_bytes < 0) {
      // no shared memory asked for beyond the staged prefix: L1 keeps the
      // rest of the SM's 256 KB for the vector
      err = cudaFuncSetAttribute(spmv_ell_kernel<T, kVec>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    attribute_bytes = smem;
  }
  spmv_ell_kernel<T, kVec><<<grid, kDirectThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(val), static_cast<const int*>(col),
      static_cast<const T*>(vec), static_cast<const float*>(bias),
      static_cast<const int*>(perm), static_cast<float*>(out), rows, width,
      rows_per_slab, stage, epilogue);
  return static_cast<int>(cudaGetLastError());
}

// One CTA an SM (fewer for fewer slabs), each staging vec[0, s) with
// s = min(cols, kDirectStageBytes of T, a CTA's slots / kStageShare), so
// that a small matrix does not pay for a large copy.
template <typename T>
int launch_direct(const void* val, const void* col, const void* vec,
                  const void* bias, const void* perm, void* out, int rows,
                  int width, int cols, int rows_per_slab, int epilogue,
                  int vec_path, void* stream) {
  int sms = 0;
  const int err = sm_count(&sms);
  if (err != 0) return err;
  const int64_t slabs = (static_cast<int64_t>(rows) + rows_per_slab - 1)
                        / rows_per_slab;
  const int grid = static_cast<int>(slabs < sms ? slabs : sms);
  const int64_t cap = kDirectStageBytes / static_cast<int>(sizeof(T));
  int64_t s = static_cast<int64_t>(rows) * width / (kStageShare * grid);
  s = s < cap ? s : cap;
  s = s < cols ? s : cols;
  return vec_path
             ? launch_direct_body<T, true>(val, col, vec, bias, perm, out,
                                           rows, width, rows_per_slab,
                                           epilogue, static_cast<int>(s), grid,
                                           stream)
             : launch_direct_body<T, false>(val, col, vec, bias, perm, out,
                                            rows, width, rows_per_slab,
                                            epilogue, static_cast<int>(s),
                                            grid, stream);
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

// Shared memory of a staged CTA: the window, or the parts' sums at the end.
template <typename T>
int staged_smem(int window, int per_cta, int parts) {
  const int vec_bytes = window * static_cast<int>(sizeof(T));
  const int sum_bytes = per_cta * parts * kSlab * static_cast<int>(sizeof(float));
  return vec_bytes > sum_bytes ? vec_bytes : sum_bytes;
}

template <typename T>
int launch_staged(const void* val, const void* col, const void* seg_ptr,
                  const void* seg_window, const void* seg_offset,
                  const void* vec, const void* bias, const void* perm,
                  void* out, int rows, int cols, int n_slabs, int window,
                  int epilogue, void* stream) {
  int sms = 0;
  cudaError_t err = static_cast<cudaError_t>(sm_count(&sms));
  if (err != cudaSuccess) return static_cast<int>(err);
  // one CTA an SM, each with an even share of the slabs, unless that share
  // exceeds what its warps hold; then more CTAs, in waves
  constexpr int kMaxPerCta = kStagedWarps * kMaxItems;
  int ctas = n_slabs < sms ? n_slabs : sms;
  int per_cta = (n_slabs + ctas - 1) / ctas;
  if (per_cta > kMaxPerCta) per_cta = kMaxPerCta;
  ctas = (n_slabs + per_cta - 1) / per_cta;
  int parts = 1;
  while (parts < kMaxParts && per_cta * parts * 2 <= kMaxPerCta) parts *= 2;
  const int smem = staged_smem<T>(window, per_cta, parts);
  static int attribute_bytes = 0;
  if (smem > attribute_bytes) {
    err = cudaFuncSetAttribute(spmv_ell_staged_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attribute_bytes = smem;
  }
  spmv_ell_staged_kernel<T><<<ctas, kStagedWarps * 32, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(val), static_cast<const uint16_t*>(col),
      static_cast<const int*>(seg_ptr), static_cast<const int*>(seg_window),
      static_cast<const int64_t*>(seg_offset), static_cast<const T*>(vec),
      static_cast<const float*>(bias), static_cast<const int*>(perm),
      static_cast<float*>(out), rows, cols, n_slabs, window, per_cta, parts,
      epilogue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// vec_path != 0: val and col 16-byte aligned and width a multiple of 4
// (f32) or 8 (bf16), so that every row starts 16-byte aligned (the wrapper
// decides); otherwise the body's scalar loads.
int spmv_ell_f32(const void* val, const void* col, const void* vec,
                 const void* bias, const void* perm, void* out, int rows,
                 int width, int cols, int rows_per_slab, int epilogue,
                 int vec_path, void* stream) {
  return launch_direct<float>(val, col, vec, bias, perm, out, rows, width,
                              cols, rows_per_slab, epilogue, vec_path,
                              stream);
}

int spmv_ell_bf16(const void* val, const void* col, const void* vec,
                  const void* bias, const void* perm, void* out, int rows,
                  int width, int cols, int rows_per_slab, int epilogue,
                  int vec_path, void* stream) {
  return launch_direct<__nv_bfloat16>(val, col, vec, bias, perm, out, rows,
                                      width, cols, rows_per_slab, epilogue,
                                      vec_path, stream);
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

int spmv_ell_staged_f32(const void* val, const void* col, const void* seg_ptr,
                        const void* seg_window, const void* seg_offset,
                        const void* vec, const void* bias, const void* perm,
                        void* out, int rows, int cols, int n_slabs,
                        int window, int epilogue, void* stream) {
  return launch_staged<float>(val, col, seg_ptr, seg_window, seg_offset, vec,
                              bias, perm, out, rows, cols, n_slabs, window,
                              epilogue, stream);
}

int spmv_ell_staged_bf16(const void* val, const void* col,
                         const void* seg_ptr, const void* seg_window,
                         const void* seg_offset, const void* vec,
                         const void* bias, const void* perm, void* out,
                         int rows, int cols, int n_slabs, int window,
                         int epilogue, void* stream) {
  return launch_staged<__nv_bfloat16>(val, col, seg_ptr, seg_window,
                                      seg_offset, vec, bias, perm, out, rows,
                                      cols, n_slabs, window, epilogue, stream);
}

}  // extern "C"
