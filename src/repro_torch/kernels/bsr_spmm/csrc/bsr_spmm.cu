// BCSR SpMM on Hopper (K3) over packed tiles, with the fused
// (+bias) -> relu|silu epilogue (K5).
//
// Replaces the TPU kernel in src/repro/kernels/bsr_spmm/kernel.py:
//   bsr_spmm_wide_kernel, bsr_spmm_narrow_kernel
//                        <- bsr_spmm_pallas (body _bsr_spmm_kernel)
//   epilogue_inregister  <- kernels/common.py apply_epilogue_inregister
//
// Computes, for block row r and its tiles t in
// block_rowptr[r] .. block_rowptr[r+1]:
//   out[r*bm + i, c] = epilogue(sum_t sum_k A_t[i][k]
//                                 * dense[block_col[t]*bk + k, c] + bias)
// with a row bias (bias[r*bm + i]) or a column bias (bias[c]), in f32
// whatever the storage type.  The tiles come packed
// (sparse/formats.py:PackedBCSR): tile t's entries are val/local[tile_ptr[t]
// ..], ordered by (i, k), local = i*bk + k as uint16, and row i of the tile
// starts at row_start[t][i].  Rows of `dense` past its end read as zeros;
// columns past N and rows past out_rows are masked; a block row without
// entries stores epilogue(0 + bias), so the epilogue always fuses.
//
// Bound.  The Pallas kernel multiplies dense 128x128 tiles on the MXU.  On
// a sparse operator the tiles are nearly empty (1.9 % at HPCG's 27-point
// stencil: 6.26 GB of f32 tiles for 0.18 GB of entries), and any body that
// reads dense tiles pays for them in HBM bytes.  Packed, the function moves
// its entries at 6 B each (f32 value, 16-bit id) plus `dense` and `out`
// once: ~0.40 ms at HPCG x 128, ~0.056 ms at N = 1.  The useful flops
// (2*nnz*N) are ~0.1 ms of the f32 rate, so there is nothing for tensor
// cores to win, and f32 on them would mean TF32.  What remains above the
// bound is the L2 traffic of the operand rows: each tile reads its bk rows
// of `dense` (64 KB at N = 128, 6.26 GB a call at HPCG; 4.5 GB of rows the
// tiles use), and the products: one 16-byte shared load and 4 FMAs a lane
// for each entry, 29.8 M of them at HPCG.
//
// Wide body (N > 8): a CTA for each 128 columns and run of ~4 block rows
// (an even share of the tiles), walking the run's tiles in order; the CTAs
// resident at a time cover neighbouring block rows, so the operand rows
// that several of them read stay in L2 (one CTA an SM, each with a long
// run, spread the CTAs over the matrix and read most of them from HBM).
//   * One producer warp stages, for each tile, the operand rows the tile
//     uses (its column mask, ~72 % of them at HPCG) into a 3-stage ring in
//     shared memory with TMA bulk copies counted on the stage's `full`
//     mbarrier: one per run of consecutive used rows where the rows lie
//     back to back in `dense` (N = 128), else one per row.  It refills a
//     stage once the 16 consumer warps have arrived on its `empty`
//     mbarrier, so the consumers never wait on each other and copies of
//     two tiles are in flight while one is multiplied.
//   * Consumer warp w owns the tile rows 8w .. 8w+7, lane l the columns
//     4l .. 4l+3: the block row's output tile stays in registers (8 float4
//     a lane) across its tiles, and K5 runs on it before the one store.
//   * A consumer reads its band's entries 32 at a time, coalesced, and
//     hands each to all lanes by shuffle.  Rows are an unrolled loop, each
//     with its own entry range, so the accumulator index is static; an
//     entry costs one conflict-free 16-byte shared load and 4 FMAs a lane.
//     A tile's offsets are read two tiles ahead, its first 32 entries of
//     the band one ahead, and each next 32 while the current 32 are used.
// Narrow body (N <= 8, the SpMV path at N = 1): one CTA per block row, a
// thread a row, BN (1 or 8) accumulators; the thread walks its row's
// entries tile by tile and reads `dense` through L1.
//
// C interface for ctypes: each entry point launches on the given stream
// and returns cudaGetLastError(), so a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;             // wide body: consumer warps
constexpr int kRows = 8;               // tile rows a consumer warp owns
constexpr int kMaxBM = kWarps * kRows; // 128: a tile's bm is at most this
constexpr int kMaxBK = 128;            // staged rows of `dense`
constexpr int kWideBN = 128;           // columns of a wide CTA: 4 a lane
constexpr int kStages = 3;             // the wide body's ring of stages
constexpr int kRunRows = 4;            // block rows a wide CTA walks
constexpr int kWideThreads = (kWarps + 1) * 32;  // + the producer warp
constexpr int kNarrowThreads = kMaxBM; // narrow body: a thread a row

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Four consecutive staged values as f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One TMA bulk copy of `bytes` (a multiple of 16) from global to shared
// memory, counted on the mbarrier `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
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

// Tile t's column mask (bk <= 128: at most four words), and its bit r.
__device__ __forceinline__ uint4 load_mask(const int* __restrict__ col_mask,
                                           int64_t t, int bk) {
  const int words = (bk + 31) / 32;
  const int* m = col_mask + t * words;
  return make_uint4(m[0], words > 1 ? m[1] : 0, words > 2 ? m[2] : 0,
                    words > 3 ? m[3] : 0);
}
__device__ __forceinline__ bool mask_bit(const uint4& m, int r) {
  const unsigned w = r < 32 ? m.x : r < 64 ? m.y : r < 96 ? m.z : m.w;
  return (w >> (r & 31)) & 1u;
}
// The mask's bits below `count` (the operand rows that exist).
__device__ __forceinline__ uint4 mask_below(const uint4& m, int count) {
  auto low = [](int c) {
    return c >= 32 ? 0xffffffffu : c <= 0 ? 0u : (1u << c) - 1u;
  };
  return make_uint4(m.x & low(count), m.y & low(count - 32),
                    m.z & low(count - 64), m.w & low(count - 96));
}
// The first row at or past `from` whose bit is `set` (128 if none).
__device__ __forceinline__ int next_row(const uint4& m, int from, bool set) {
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    unsigned word = w == 0 ? m.x : w == 1 ? m.y : w == 2 ? m.z : m.w;
    if (!set) word = ~word;
    if (w == from >> 5) word &= ~0u << (from & 31);
    if (w >= from >> 5 && word != 0u) return w * 32 + __ffs(word) - 1;
  }
  return 128;
}

// bias_kind: 0 = none, 1 = row (bias[row]), 2 = column (bias[col]).
__device__ __forceinline__ float bias_of(const float* bias, int bias_kind,
                                         int64_t row, int col) {
  return bias_kind == 1 ? bias[row] : bias_kind == 2 ? bias[col] : 0.0f;
}

// Wide body.  `ldd` is dense's row stride, a multiple of the elements of a
// 16-byte chunk (the wrapper pads a ragged N); columns past n are masked.
// CTA (blockIdx.x, blockIdx.y) walks the tiles of a contiguous run of block
// rows, chosen so that each CTA gets about as many tiles; blockIdx.y picks
// the 128 columns.  Warps 0..kWarps-1 multiply; warp kWarps stages.
template <typename T>
__global__ void __launch_bounds__(kWideThreads, 1)
bsr_spmm_wide_kernel(const T* __restrict__ val,
                     const uint16_t* __restrict__ local,
                     const int64_t* __restrict__ tile_ptr,
                     const uint16_t* __restrict__ row_start,
                     const int* __restrict__ col_mask,
                     const int* __restrict__ block_col,
                     const int* __restrict__ block_rowptr,
                     const T* __restrict__ dense,
                     const float* __restrict__ bias, float* __restrict__ out,
                     int bm, int bk, int kdim, int ldd, int n, int out_rows,
                     int bias_kind, int epilogue) {
  constexpr int kStage = kMaxBK * kWideBN;    // elements of a stage
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* stages = reinterpret_cast<T*>(smem_raw);
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  __shared__ int run[2];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.y * kWideBN;
  const int block_rows = (out_rows + bm - 1) / bm;

  // The CTA's block rows: the first block row whose first tile is at or
  // past its share of the tiles (a binary search over block_rowptr).
  if (threadIdx.x < 2) {
    const int64_t tiles = block_rowptr[block_rows];
    const int64_t want = tiles * (blockIdx.x + threadIdx.x) / gridDim.x;
    int lo = 0, hi = block_rows;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (block_rowptr[mid] < want) lo = mid + 1; else hi = mid;
    }
    run[threadIdx.x] = blockIdx.x + threadIdx.x == gridDim.x ? block_rows
                                                             : lo;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int br_first = run[0];
  const int br_last = run[1];
  const int first = block_rowptr[br_first];
  const int last = block_rowptr[br_last];

  if (warp == kWarps) {
    // The producer: for each tile, once its stage is free, TMA bulk copies
    // of the operand rows the tile uses (its column mask): one per run of
    // consecutive rows where the rows lie back to back (ldd == 128, as at
    // N = 128), else one per row, lane r taking rows r, r+32, ...; used
    // rows past kdim are zero-filled instead.
    const int row_elems = min(kWideBN, ldd - n0);
    const uint32_t row_bytes = row_elems * sizeof(T);
    const bool runs = ldd == kWideBN;
    for (int t = first; t < last; ++t) {
      const int j = t - first;
      const int s = j % kStages;
      const int64_t krow0 = static_cast<int64_t>(block_col[t]) * bk;
      const uint4 mask = load_mask(col_mask, t, bk);
      const int rows_in = static_cast<int>(
          kdim - krow0 < bk ? (kdim > krow0 ? kdim - krow0 : 0) : bk);
      const uint4 copied = mask_below(mask, rows_in);
      T* dst = stages + s * kStage;
      const uint32_t bar = smem_u32(&full[s]);
      // a fresh barrier passes parity 1: the first round does not wait
      mbar_wait(smem_u32(&empty[s]), ((j / kStages) & 1) ^ 1);
      for (int r = rows_in + lane; r < bk; r += 32) {
        if (mask_bit(mask, r)) {
          for (int c = 0; c < kWideBN; ++c) dst[r * kWideBN + c] = T(0.0f);
        }
      }
      __syncwarp();
      if (lane == 0) {
        const int rows = __popc(copied.x) + __popc(copied.y)
                         + __popc(copied.z) + __popc(copied.w);
        mbar_expect_tx(bar, rows * row_bytes);
        if (runs) {
          for (int r = next_row(copied, 0, true); r < rows_in;
               r = next_row(copied, r, true)) {
            const int e = next_row(copied, r, false);
            bulk_copy(smem_u32(dst + r * kWideBN),
                      dense + (krow0 + r) * ldd + n0, (e - r) * row_bytes,
                      bar);
            r = e;
          }
        }
      }
      __syncwarp();
      if (!runs) {
        for (int r = lane; r < rows_in; r += 32) {
          if (mask_bit(copied, r)) {
            bulk_copy(smem_u32(dst + r * kWideBN),
                      dense + (krow0 + r) * ldd + n0, row_bytes, bar);
          }
        }
      }
    }
    return;
  }

  // The consumers.
  const int row0 = warp * kRows;  // the warp's first tile row
  const int col = n0 + lane * 4;
  // A tile's place for this warp: its first entry (the wrapper keeps the
  // entries below 2^31), and in lane r <= kRows where the band's row r
  // starts (past bm or at kRows: the band's end).
  auto meta = [&](int t, int& base, int& rs) {
    base = 0;
    rs = 0;
    if (t < last) {
      base = static_cast<int>(tile_ptr[t]);
      const int nnz = static_cast<int>(tile_ptr[t + 1]) - base;
      rs = nnz;
      if (lane <= kRows && row0 + lane < bm) {
        rs = row_start[static_cast<int64_t>(t) * bm + row0 + lane];
      }
    }
  };
  // The entries p .. p+31 of a tile, a lane each (0 past `end`).
  auto entries = [&](int base, int p, int end, float& v, int& loc) {
    v = 0.0f;
    loc = 0;
    if (p < end) {
      v = to_f32(val[base + p]);
      loc = local[base + p];
    }
  };
  auto store = [&](int64_t br, float4 (&acc)[kRows]) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int64_t row = br * bm + row0 + r;
      if (row0 + r < bm && row < out_rows && col < n) {
        const float a[4] = {acc[r].x, acc[r].y, acc[r].z, acc[r].w};
        float o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          o[j] = epilogue_inregister(
              a[j],
              col + j < n ? bias_of(bias, bias_kind, row, col + j) : 0.0f,
              epilogue);
        }
        float* dst = out + row * n + col;
        if ((n & 3) == 0) {
          *reinterpret_cast<float4*>(dst) =
              make_float4(o[0], o[1], o[2], o[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (col + j < n) dst[j] = o[j];
          }
        }
      }
      acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };

  float4 acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);

  // the places of tiles first and first+1, and first's first 32 entries
  int base_cur, base_nxt;
  int rs_cur, rs_nxt;
  meta(first, base_cur, rs_cur);
  meta(first + 1, base_nxt, rs_nxt);
  float v_cur;
  int loc_cur;
  entries(base_cur, __shfl_sync(0xffffffffu, rs_cur, 0) + lane,
          __shfl_sync(0xffffffffu, rs_cur, kRows), v_cur, loc_cur);

  int64_t br = br_first;
  int br_end = br_first < br_last ? block_rowptr[br_first + 1] : 0;
  for (int t = first; t < last; ++t) {
    // finish the block rows that end before tile t (with no tiles too)
    while (t >= br_end) {
      store(br, acc);
      ++br;
      br_end = block_rowptr[br + 1];
    }
    const int j = t - first;
    const int s = j % kStages;
    int base_far;
    int rs_far;
    meta(t + 2, base_far, rs_far);
    // tile t+1's first entries, read while tile t is multiplied
    float v_nxt;
    int loc_nxt;
    entries(base_nxt, __shfl_sync(0xffffffffu, rs_nxt, 0) + lane,
            __shfl_sync(0xffffffffu, rs_nxt, kRows), v_nxt, loc_nxt);
    int bound[kRows + 1];
#pragma unroll
    for (int r = 0; r <= kRows; ++r) {
      bound[r] = __shfl_sync(0xffffffffu, rs_cur, r);
    }
    mbar_wait(smem_u32(&full[s]), (j / kStages) & 1);  // tile t has landed

    const T* hs = stages + s * kStage + lane * 4;
    float v = v_cur;
    int loc = loc_cur;
    for (int c0 = bound[0]; c0 < bound[kRows]; c0 += 32) {
      float v2;
      int loc2;
      entries(base_cur, c0 + 32 + lane, bound[kRows], v2, loc2);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        int q = max(bound[r], c0);
        const int hi = min(bound[r + 1], c0 + 32);
        const int ioff = (row0 + r) * bk;
        for (; q + 1 < hi; q += 2) {
          const float va = __shfl_sync(0xffffffffu, v, q - c0);
          const float vb = __shfl_sync(0xffffffffu, v, q + 1 - c0);
          const int ka = __shfl_sync(0xffffffffu, loc, q - c0) - ioff;
          const int kb = __shfl_sync(0xffffffffu, loc, q + 1 - c0) - ioff;
          const float4 ha = load4(hs + ka * kWideBN);
          const float4 hb = load4(hs + kb * kWideBN);
          acc[r].x = fmaf(vb, hb.x, fmaf(va, ha.x, acc[r].x));
          acc[r].y = fmaf(vb, hb.y, fmaf(va, ha.y, acc[r].y));
          acc[r].z = fmaf(vb, hb.z, fmaf(va, ha.z, acc[r].z));
          acc[r].w = fmaf(vb, hb.w, fmaf(va, ha.w, acc[r].w));
        }
        if (q < hi) {
          const float va = __shfl_sync(0xffffffffu, v, q - c0);
          const int ka = __shfl_sync(0xffffffffu, loc, q - c0) - ioff;
          const float4 ha = load4(hs + ka * kWideBN);
          acc[r].x = fmaf(va, ha.x, acc[r].x);
          acc[r].y = fmaf(va, ha.y, acc[r].y);
          acc[r].z = fmaf(va, ha.z, acc[r].z);
          acc[r].w = fmaf(va, ha.w, acc[r].w);
        }
      }
      v = v2;
      loc = loc2;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&empty[s]));  // the stage is free
    base_cur = base_nxt;
    rs_cur = rs_nxt;
    base_nxt = base_far;
    rs_nxt = rs_far;
    v_cur = v_nxt;
    loc_cur = loc_nxt;
  }
  // the last block row with tiles, and any after it without
  for (; br < br_last; ++br) store(br, acc);
}

// Narrow body: thread i owns row i of block row blockIdx.x and BN <= 8
// columns; `ldd` is dense's row stride.
template <int BN, typename T>
__global__ void __launch_bounds__(kNarrowThreads)
bsr_spmm_narrow_kernel(const T* __restrict__ val,
                       const uint16_t* __restrict__ local,
                       const int64_t* __restrict__ tile_ptr,
                       const uint16_t* __restrict__ row_start,
                       const int* __restrict__ block_col,
                       const int* __restrict__ block_rowptr,
                       const T* __restrict__ dense,
                       const float* __restrict__ bias, float* __restrict__ out,
                       int bm, int bk, int kdim, int ldd, int n, int out_rows,
                       int bias_kind, int epilogue) {
  const int i = threadIdx.x;
  const int64_t br = blockIdx.x;
  const int64_t row = br * bm + i;
  if (i >= bm || row >= out_rows) return;
  float acc[BN];
#pragma unroll
  for (int c = 0; c < BN; ++c) acc[c] = 0.0f;
  const int ioff = i * bk;
  const int last = block_rowptr[br + 1];
  for (int t = block_rowptr[br]; t < last; ++t) {
    const int64_t base = tile_ptr[t];
    const int64_t rs = static_cast<int64_t>(t) * bm + i;
    const int s = row_start[rs];
    const int e = i + 1 < bm ? row_start[rs + 1]
                             : static_cast<int>(tile_ptr[t + 1] - base);
    const int64_t krow0 = static_cast<int64_t>(block_col[t]) * bk - ioff;
    for (int p = s; p < e; ++p) {
      const float v = to_f32(val[base + p]);
      const int64_t k = krow0 + local[base + p];
      if (k < kdim) {
        const T* d = dense + k * ldd;
#pragma unroll
        for (int c = 0; c < BN; ++c) {
          if (c < n) acc[c] = fmaf(v, to_f32(d[c]), acc[c]);
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < BN; ++c) {
    if (c < n) {
      out[row * n + c] = epilogue_inregister(
          acc[c], bias_of(bias, bias_kind, row, c), epilogue);
    }
  }
}

template <typename T>
int launch(const void* val, const void* local, const void* tile_ptr,
           const void* row_start, const void* col_mask, const void* block_col,
           const void* block_rowptr, const void* dense, const void* bias,
           void* out, int bm, int bk, int kdim, int ldd, int n, int out_rows,
           int bias_kind, int epilogue, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int block_rows =
      static_cast<unsigned int>((static_cast<int64_t>(out_rows) + bm - 1) / bm);
  const T* v = static_cast<const T*>(val);
  const uint16_t* l = static_cast<const uint16_t*>(local);
  const int64_t* tp = static_cast<const int64_t*>(tile_ptr);
  const uint16_t* rs = static_cast<const uint16_t*>(row_start);
  const int* cm = static_cast<const int*>(col_mask);
  const int* bc = static_cast<const int*>(block_col);
  const int* brp = static_cast<const int*>(block_rowptr);
  const T* d = static_cast<const T*>(dense);
  const float* b = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  if (n == 1) {
    bsr_spmm_narrow_kernel<1, T><<<block_rows, kNarrowThreads, 0, s>>>(
        v, l, tp, rs, bc, brp, d, b, o, bm, bk, kdim, ldd, n, out_rows,
        bias_kind, epilogue);
  } else if (n <= 8) {
    bsr_spmm_narrow_kernel<8, T><<<block_rows, kNarrowThreads, 0, s>>>(
        v, l, tp, rs, bc, brp, d, b, o, bm, bk, kdim, ldd, n, out_rows,
        bias_kind, epilogue);
  } else {
    const int smem = kStages * kMaxBK * kWideBN * static_cast<int>(sizeof(T));
    static bool attribute_set = false;
    if (!attribute_set) {
      const cudaError_t err = cudaFuncSetAttribute(
          bsr_spmm_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      attribute_set = true;
    }
    // a CTA for each run of about kRunRows block rows (its share of the
    // tiles) and 128 columns; one fits an SM (the stages fill its shared
    // memory), and the CTAs go in order, so the ones on the card at a time
    // cover ~132 * kRunRows neighbouring block rows, whose operand rows
    // (three bands of the stencil) stay in L2 between their users
    const dim3 grid((block_rows + kRunRows - 1) / kRunRows,
                    (n + kWideBN - 1) / kWideBN);
    bsr_spmm_wide_kernel<T><<<grid, kWideThreads, smem, s>>>(
        v, l, tp, rs, cm, bc, brp, d, b, o, bm, bk, kdim, ldd, n, out_rows,
        bias_kind, epilogue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int bsr_spmm_f32(const void* val, const void* local, const void* tile_ptr,
                 const void* row_start, const void* col_mask,
                 const void* block_col, const void* block_rowptr,
                 const void* dense, const void* bias, void* out, int bm,
                 int bk, int kdim, int ldd, int n, int out_rows,
                 int bias_kind, int epilogue, void* stream) {
  return launch<float>(val, local, tile_ptr, row_start, col_mask, block_col,
                       block_rowptr, dense, bias, out, bm, bk, kdim, ldd, n,
                       out_rows, bias_kind, epilogue, stream);
}

int bsr_spmm_bf16(const void* val, const void* local, const void* tile_ptr,
                  const void* row_start, const void* col_mask,
                  const void* block_col, const void* block_rowptr,
                  const void* dense, const void* bias, void* out, int bm,
                  int bk, int kdim, int ldd, int n, int out_rows,
                  int bias_kind, int epilogue, void* stream) {
  return launch<__nv_bfloat16>(val, local, tile_ptr, row_start, col_mask,
                               block_col, block_rowptr, dense, bias, out, bm,
                               bk, kdim, ldd, n, out_rows, bias_kind,
                               epilogue, stream);
}

}  // extern "C"
