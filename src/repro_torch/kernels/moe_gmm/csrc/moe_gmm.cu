// Group-aligned grouped matmul on Hopper (K4): the MoE expert hot loop.
//
// Replaces the TPU kernel in src/repro/kernels/moe_gmm/kernel.py:
//   gmm_tc_kernel (bf16), gmm_simt_kernel (f32) <- gmm_pallas (body _gmm_kernel)
//
// Computes out[i, :] = xs[i, :] @ w[tile_expert[i / tm]] for every row i
// of the (Tp, D) operand, whose rows are grouped by expert and padded to
// whole tm-row tiles, with w (E, D, F): out (Tp, F) in f32, summed in f32
// whatever the storage type (the reference's preferred_element_type).
// Called three times per MoE FFN (gate, up, down).  Rows of the tail tiles
// that belong to no group are zeros and give zeros, as in the reference.
// Expert ids follow the reference's indexing rule: a negative id counts
// from the end, then the id is clamped into [0, E), so no id reads past w.
//
// The Pallas grid (m_tiles, n_tiles, k_tiles) revisits the output block
// over k and steers the weight DMA by the scalar-prefetched tile_expert.
// Here one CTA owns one (row block, 128-column tile) pair and loops over D
// itself; a row block is one tile, or 128 rows of a taller tile, so every
// row of a CTA has the same expert, which the CTA reads from tile_expert.
//
// bf16 (the OLMoE path): bound.  At OLMoE's gate/up call (32,768 routed
// rows of 2,048, weights 64 x 2,048 x 1,024) the function moves ~0.54 GB
// and does 137 GFLOP: ~0.16 ms at the card's memory rate, ~0.14 ms at its
// bf16 tensor-core rate.  The design serves both:
//   * the products run on the tensor cores: wgmma.mma_async m64n128k16,
//     bf16 in, f32 sum in registers; two consumer warpgroups take 64 rows
//     each of the 128 x 128 CTA tile;
//   * one producer warp keeps a ring of kStages shared-memory stages full
//     with TMA loads (one thread issues them; an mbarrier per stage says
//     "full", another "empty").  A stage is 64 deep: the xs tile (128 rows
//     x 64, K-major) and the w[e] tile (64 x 128, two boxes of 64 columns;
//     N-major, so wgmma reads it transposed), both in the 128-byte swizzle
//     that wgmma's descriptors name;
//   * expert steering: one 2-D tensor map over xs (Tp, D) and one 3-D map
//     over w (E, D, F); the CTA puts its expert in the map's third
//     coordinate.  TMA zero-fills what lies past D, F or Tp, so a D that is
//     not a multiple of 64 and the column edge need no code;
//   * the grid walks the column tiles fastest, so the CTAs that share an
//     xs row block run together and read it from L2, and consecutive row
//     blocks (mostly one expert) share w[e];
//   * the f32 sum is stored once, as float2 pairs, masked to the CTA's rows
//     (tm < 128 leaves the rest of the 128-row tile unused: correct, not
//     fast) and to F.
// TMA needs 16-byte strides: D and F must be multiples of 8 (the wrapper
// checks; OLMoE's are 2,048 and 1,024).  The tensor maps are encoded here,
// on the host, through the driver entry point that the runtime hands out,
// so the library links nothing beyond the CUDA runtime.
//
// f32 (gmm_simt_kernel; the body of a model with f32 parameters): FFMA on
// the CUDA cores, no TF32 and no tensor core, so each output is the f32
// sum over k = 0, 1, ..., D-1 in that order, one fmaf a step, whatever tm
// is.  Bound by operations: at OLMoE's gate/up call, 137 GFLOP over the
// routed rows (171 over all Tp rows, the tail tiles included) against the
// CUDA cores' ~67 TFLOP/s, ~2.05 ms; the bytes (~0.9 GB) take ~0.28 ms.
// So the design keeps the FMA pipes fed:
//   * 256 threads, each an 8x8 tile of the CTA's 128x128 laid out as 2x2
//     blocks of 4x4, so that a thread reads its A and B fragments with
//     four LDS.128 a depth step, for 64 FFMA;
//   * xs (A) is loaded 16 bytes a thread and stored k-major into shared
//     memory, its float4 blocks XOR-swizzled so that the transposing store
//     meets no bank conflict; w[e] (B) goes straight into shared memory
//     with 16-byte cp.async;
//   * two stages of depth 8: the next chunk's loads are in flight during
//     this chunk's FMAs, with one __syncthreads a chunk;
//   * __launch_bounds__(256, 2): two CTAs an SM, so that one CTA's barrier
//     is hidden by the other's FMAs;
//   * column tiles fastest, as in the bf16 body.
// Inputs with D or F not a multiple of 4, or xs or w not 16-byte aligned,
// take the same body with masked scalar loads and stores (the template's
// kVec = false).  Offsets into w (64 x 2,048 x 1,024 = 134 M elements) are
// 64-bit.
//
// C interface for ctypes: each entry point launches on the given stream
// and returns a cudaError (cudaGetLastError() after the launch), so a
// refused launch is reported.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int clamp_expert(int e, int n_experts) {
  if (e < 0) e += n_experts;
  return min(max(e, 0), n_experts - 1);
}

// ---------------------------------------------------------------------------
// bf16: TMA ring + wgmma
// ---------------------------------------------------------------------------

constexpr int kBM = 128;                  // rows of a CTA tile
constexpr int kBN = 128;                  // columns of a CTA tile
constexpr int kBK = 64;                   // depth of a stage (128 bytes)
constexpr int kStages = 3;
constexpr int kConsumers = 256;           // two warpgroups
constexpr int kThreadsTC = kConsumers + 32;   // and one producer warp
constexpr int kATile = kBM * kBK * 2;     // 16 KB
constexpr int kBHalf = kBK * 64 * 2;      // 8 KB: 64 k-rows x 64 columns
constexpr int kStageBytes = kATile + 2 * kBHalf;
constexpr int kSmemTC = kStages * kStageBytes + 1024;  // + alignment slack

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

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (all >> 4), layout 1 = B128.
// K-major (xs): rows of 128 bytes, 8-row groups 1,024 bytes apart (stride);
// the leading offset is unused.  N-major (w): 8-k-row groups 1,024 bytes
// apart (stride), 64-column blocks kBHalf apart (leading).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lead,
                                              uint32_t stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lead >> 4) << 16 |
         static_cast<uint64_t>(stride >> 4) << 32 | 1ull << 62;
}

// Keep the compiler from moving the accumulators across the asynchronous
// wgmma window.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128 f32, this warpgroup's fragment) += A (64 x 16, K-major) *
// B (16 x 128, N-major: transposed).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  const int scale_d = 1;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// CTA b computes columns [c*128, c*128 + 128) of rows [r*rb, r*rb + rb),
// with c = b % n_col_tiles and r = b / n_col_tiles (column tiles fastest);
// rb <= 128 divides tm (or equals it).
__global__ void __launch_bounds__(kThreadsTC, 2)
gmm_tc_kernel(__grid_constant__ const CUtensorMap xs_map,
              __grid_constant__ const CUtensorMap w_map,
              const int* __restrict__ tile_expert, float* __restrict__ out,
              int f, int n_experts, int tm, int rb, int n_col_tiles,
              int n_chunks) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  // the 128-byte swizzle repeats every 1,024 bytes: align the stages to it
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int c0 = (blockIdx.x % n_col_tiles) * kBN;
  const int r0 = (blockIdx.x / n_col_tiles) * rb;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer warp: one thread keeps up to kStages chunks in flight
    if (threadIdx.x == kConsumers) {
      const int e = clamp_expert(tile_expert[r0 / tm], n_experts);
      for (int kc = 0; kc < n_chunks; ++kc) {
        const int s = kc % kStages;
        // a fresh barrier passes parity 1: the first round does not wait
        mbar_wait(smem_u32(&empty[s]), ((kc / kStages) & 1) ^ 1);
        const uint32_t bar = smem_u32(&full[s]);
        const uint32_t a = ring + s * kStageBytes;
        mbar_expect_tx(bar, kStageBytes);
        tma_load_2d(a, &xs_map, bar, kc * kBK, r0);
        tma_load_3d(a + kATile, &w_map, bar, c0, kc * kBK, e);
        tma_load_3d(a + kATile + kBHalf, &w_map, bar, c0 + 64, kc * kBK, e);
      }
    }
    return;
  }

  // consumers: warpgroup wg takes rows [64*wg, 64*wg + 64) of the tile
  const int wg = threadIdx.x / 128;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  for (int kc = 0; kc < n_chunks; ++kc) {
    const int s = kc % kStages;
    mbar_wait(smem_u32(&full[s]), (kc / kStages) & 1);
    const uint32_t a = ring + s * kStageBytes + wg * (64 * kBK * 2);
    const uint32_t b = ring + s * kStageBytes + kATile;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // 16 deep: 32 bytes along an xs row; 16 k-rows (2,048 bytes) of w
      wgmma_m64n128k16(acc, smem_desc(a + kk * 32, 16, 1024),
                       smem_desc(b + kk * 2048, kBHalf, 1024));
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(acc);
    mbar_arrive(smem_u32(&empty[s]));
  }

  // accumulator fragment: acc[4j + q] is row 16*warp + lane/4 + 8*(q/2),
  // column 8j + 2*(lane%4) + q%2 of this warpgroup's 64 x 128 block
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int row = wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = c0 + j * 8 + (lane % 4) * 2;
    if (col >= f) continue;  // F is a multiple of 8: col + 1 < F too
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = row + 8 * h;
      if (i >= rb) continue;
      *reinterpret_cast<float2*>(out + static_cast<int64_t>(r0 + i) * f +
                                 col) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A bf16 tensor map of `rank` dims (innermost first), 128-byte swizzle,
// out-of-bounds elements read as zeros.
bool encode(CUtensorMap* map, const void* base, int rank,
            const cuuint64_t* dims, const cuuint64_t* strides,
            const cuuint32_t* box) {
  const EncodeTiled fn = encoder();
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_tc(const void* xs, const void* w, const void* tile_expert,
              void* out, int tp, int d, int f, int n_experts, int tm,
              void* stream) {
  CUtensorMap xs_map, w_map;
  const cuuint64_t xs_dims[2] = {static_cast<cuuint64_t>(d),
                                 static_cast<cuuint64_t>(tp)};
  const cuuint64_t xs_strides[1] = {static_cast<cuuint64_t>(d) * 2};
  const cuuint32_t xs_box[2] = {kBK, kBM};
  const cuuint64_t w_dims[3] = {static_cast<cuuint64_t>(f),
                                static_cast<cuuint64_t>(d),
                                static_cast<cuuint64_t>(n_experts)};
  const cuuint64_t w_strides[2] = {static_cast<cuuint64_t>(f) * 2,
                                   static_cast<cuuint64_t>(d) * f * 2};
  const cuuint32_t w_box[3] = {64, kBK, 1};
  if (!encode(&xs_map, xs, 2, xs_dims, xs_strides, xs_box) ||
      !encode(&w_map, w, 3, w_dims, w_strides, w_box)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        gmm_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemTC);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const int rb = tm < kBM ? tm : kBM;
  const int n_col_tiles = (f + kBN - 1) / kBN;
  const unsigned int blocks = static_cast<unsigned int>(tp / rb) * n_col_tiles;
  gmm_tc_kernel<<<blocks, kThreadsTC, kSmemTC,
                  static_cast<cudaStream_t>(stream)>>>(
      xs_map, w_map, static_cast<const int*>(tile_expert),
      static_cast<float*>(out), f, n_experts, tm, rb, n_col_tiles,
      (d + kBK - 1) / kBK);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32: SIMT, double-buffered, 128-bit shared-memory fragments
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kSK = 8;            // depth of a stage
constexpr int kQuads = kSK / 4;   // float4s of an A row in a stage
constexpr int kLoads = kSK / 8;   // float4s of A (and of B) a thread loads
constexpr int kWarpM = 64;        // a warp's tile: 64 rows x 32 columns,
constexpr int kWarpN = 32;        // the CTA's 8 warps 2 x 4
constexpr int kStageFloats = kSK * (kBM + kBN);

// As is k-major: row k of a stage holds the 128 rows' values at depth k.
// The float4 block b of row k sits at block b ^ (8 / kQuads) * ((k / 4) %
// kQuads), so that a warp's transposing store (32 / kQuads rows x kSK
// depths, one depth per STS) hits 32 banks, and a thread still reads 4
// consecutive rows as one LDS.128.
__device__ __forceinline__ int a_slot(int k, int m) {
  return (((m >> 2) ^ (((k >> 2) % kQuads) * (8 / kQuads))) << 2) | (m & 3);
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool in_range) {
  const uint32_t dst = smem_u32(smem);
  const int bytes = in_range ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(gmem), "r"(bytes)
               : "memory");
}

// The operands of one stage, as a thread loads them: its j-th A float4 is
// row i / kQuads, depths 4 * (i % kQuads) .. +3 with i = t + 256 * j (a
// warp reads whole 4*kSK-byte row pieces); its j-th B float4 is depth
// i / 32, columns 4 * (i % 32) .. +3 (a warp reads one 512-byte row of
// w[e]).  kVec: 16-byte loads (D and F multiples of 4, xs and w 16-byte
// aligned; B by cp.async straight into shared memory); otherwise masked
// scalar loads through registers.
template <bool kVec>
struct Stage {
  float4 a[kLoads];
  float4 b[kLoads];  // scalar path only

  __device__ __forceinline__ void load(const float* __restrict__ xs,
                                       const float* __restrict__ we,
                                       float* bs, int64_t r0, int64_t c0,
                                       int k0, int d, int f, int rb) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = threadIdx.x + kThreads * j;
      const int m = i / kQuads;
      const int ka = k0 + 4 * (i % kQuads);
      const float* pa = xs + (r0 + m) * d + ka;
      const int kb = k0 + i / 32;
      const int64_t cb = c0 + 4 * (i % 32);
      const float* pb = we + static_cast<int64_t>(kb) * f + cb;
      if (kVec) {
        a[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (m < rb && ka < d) {
          a[j] = __ldg(reinterpret_cast<const float4*>(pa));
        }
        const bool in = kb < d && cb < f;
        cp_async16(bs + (i / 32) * kBN + 4 * (i % 32), in ? pb : we, in);
      } else {
        float av[4], bv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          av[e] = m < rb && ka + e < d ? __ldg(pa + e) : 0.f;
          bv[e] = kb < d && cb + e < f ? __ldg(pb + e) : 0.f;
        }
        a[j] = make_float4(av[0], av[1], av[2], av[3]);
        b[j] = make_float4(bv[0], bv[1], bv[2], bv[3]);
      }
    }
    if (kVec) asm volatile("cp.async.commit_group;" ::: "memory");
  }

  // Registers -> shared memory (A transposed), and B's copies landed.
  __device__ __forceinline__ void store(float* as, float* bs) const {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = threadIdx.x + kThreads * j;
      const int m = i / kQuads;
      const int k = 4 * (i % kQuads);
      as[(k + 0) * kBM + a_slot(k + 0, m)] = a[j].x;
      as[(k + 1) * kBM + a_slot(k + 1, m)] = a[j].y;
      as[(k + 2) * kBM + a_slot(k + 2, m)] = a[j].z;
      as[(k + 3) * kBM + a_slot(k + 3, m)] = a[j].w;
      if (!kVec) {
        *reinterpret_cast<float4*>(bs + (i / 32) * kBN + 4 * (i % 32)) = b[j];
      }
    }
    if (kVec) asm volatile("cp.async.wait_all;" ::: "memory");
  }
};

// CTA b computes columns [c*128, c*128 + 128) of rows [r*rb, r*rb + rb),
// with c = b % n_col_tiles and r = b / n_col_tiles (column tiles fastest);
// rb <= 128 divides tm (or equals it).  Thread (warp, lane) owns rows
// 64*(warp%2) + 4*(lane/4) + {0..3, 32..35} and columns 32*(warp/2) +
// 4*(lane%4) + {0..3, 16..19}: 2 x 2 blocks of 4 x 4.  Each output's sum
// runs over k = 0, 1, ..., D-1 in order, one fmaf a step.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
gmm_simt_kernel(const float* __restrict__ xs, const float* __restrict__ w,
                const int* __restrict__ tile_expert, float* __restrict__ out,
                int d, int f, int n_experts, int tm, int rb,
                int n_col_tiles) {
  __shared__ __align__(16) float smem[2 * kStageFloats];

  const int64_t c0 = static_cast<int64_t>(blockIdx.x % n_col_tiles) * kBN;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x / n_col_tiles) * rb;
  const int e = clamp_expert(tile_expert[r0 / tm], n_experts);
  const float* we = w + static_cast<int64_t>(e) * d * f;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = (warp & 1) * kWarpM + 4 * (lane >> 2);
  const int n0 = (warp >> 1) * kWarpN + 4 * (lane & 3);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }

  const int n_chunks = (d + kSK - 1) / kSK;
  Stage<kVec> st;
  st.load(xs, we, smem + kSK * kBM, r0, c0, 0, d, f, rb);
  st.store(smem, smem + kSK * kBM);
  __syncthreads();
  for (int kc = 0; kc < n_chunks; ++kc) {
    float* as = smem + (kc & 1) * kStageFloats;
    const float* bs = as + kSK * kBM;
    float* next = smem + ((kc + 1) & 1) * kStageFloats;
    const bool more = kc + 1 < n_chunks;
    // the next chunk's loads are in flight during this chunk's FMAs
    if (more) st.load(xs, we, next + kSK * kBM, r0, c0, (kc + 1) * kSK, d, f,
                      rb);
#pragma unroll
    for (int k = 0; k < kSK; ++k) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(as + k * kBM + a_slot(k, m0));
      const float4 a1 =
          *reinterpret_cast<const float4*>(as + k * kBM + a_slot(k, m0 + 32));
      const float4 b0 = *reinterpret_cast<const float4*>(bs + k * kBN + n0);
      const float4 b1 =
          *reinterpret_cast<const float4*>(bs + k * kBN + n0 + 16);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    // the other buffer was last read before the previous barrier
    if (more) st.store(next, next + kSK * kBM);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i & 3) + 32 * (i >> 2);
    if (row >= rb) continue;
    float* o = out + (r0 + row) * f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t c = c0 + n0 + 16 * h;
      if (kVec) {
        if (c < f) {
          *reinterpret_cast<float4*>(o + c) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                          acc[i][4 * h + 3]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (c + j < f) o[c + j] = acc[i][4 * h + j];
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// vec != 0: D and F multiples of 4 and xs, w and out 16-byte aligned (the
// wrapper decides); otherwise the masked scalar path.
int gmm_f32(const void* xs, const void* w, const void* tile_expert, void* out,
            int tp, int d, int f, int n_experts, int tm, int vec,
            void* stream) {
  const int rb = tm < kBM ? tm : kBM;
  const int n_col_tiles = (f + kBN - 1) / kBN;
  const unsigned int blocks = static_cast<unsigned int>(tp / rb) * n_col_tiles;
  auto kernel = vec ? gmm_simt_kernel<true> : gmm_simt_kernel<false>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xs), static_cast<const float*>(w),
      static_cast<const int*>(tile_expert), static_cast<float*>(out), d, f,
      n_experts, tm, rb, n_col_tiles);
  return static_cast<int>(cudaGetLastError());
}

int gmm_bf16(const void* xs, const void* w, const void* tile_expert,
             void* out, int tp, int d, int f, int n_experts, int tm,
             void* stream) {
  return launch_tc(xs, w, tile_expert, out, tp, d, f, n_experts, tm, stream);
}

}  // extern "C"
