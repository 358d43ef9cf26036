// Fused dequant matmul (K8) for Hopper at prefill shapes: a warp-specialized
// GEMM with TMA loads, a dequantizing producer warpgroup and wgmma consumers.
//
// Replaces the TPU kernel finchat_tpu/ops/quant_matmul.py _quant_matmul_2d
// (_qmm_kernel, via quant_matmul_int8 and quant_matmul_int4) for calls of
// more than 64 rows with bf16 output; quant_matmul_decode_sm90.cu serves
// the calls of at most 64 rows (decode, the fp32-logit head) and
// quant_matmul.cu ("v2") the rest (shapes TMA cannot take, more rows with
// fp32 output). It computes what v2 computes: x bf16 [M, K] times a weight stored
// as int8 [K, N] with per-column fp32 scales [N], or as int4 nibbles
// [K/2, N] (byte i holds row 2i in its low nibble and row 2i+1 in its high
// nibble, signed) with per-group scales [G, N], group g = K / G. The weight
// is bf16(float(q) * scale[k / g][n]) — the TPU kernel's cast point — the
// product accumulates in fp32 and the output is bf16.
//
// What bounds it on the H100: the bf16 tensor-core operations (2 * M * K *
// N) at a prefill chunk; the weight streams 1 or 0.5 byte per element.
//
// Design. One block of three warpgroups per BM x BN = (128 * MW) x 128
// output tile, MW = 2 or 1 by the shape (see run), the grid's M tiles
// fastest (the blocks in flight share weight tiles in L2), a loop over K in
// tiles of BK = 64:
// - the producer warpgroup (warps 0-3): one thread keeps kRawStages raw
//   weight tiles in flight by TMA (no swizzle, completion on the tile's
//   "raw" mbarrier; a tile's stage is refilled once all 128 threads have
//   arrived on its "raw empty" mbarrier); all 128 threads dequantize each
//   raw tile into the kStages-deep ring of bf16 tiles that wgmma reads,
//   then fence the generic stores into the async proxy and arrive on the
//   stage's "full" barrier. The dequantized tile is K-major (one 128-byte
//   row of 64 k values per output column n, 16-byte chunk c of row n at
//   c ^ (n % 8): the 128-byte swizzle), so the stored [K][N] weight is
//   transposed on the way: each thread reads 4 columns x 8 k rows as
//   four-byte words, and one byte permute per value both picks the value
//   out of its row's word and turns it into a float without a conversion
//   instruction (a byte b = q ^ 0x80, or a nibble ^ 8, placed under the
//   exponent of 2^23 reads 2^23 + b exactly; one subtraction leaves the
//   signed value); it scales, rounds pairs to bf16 and stores one 16-byte
//   chunk per column. Thread (warp w, lane l) owns columns 4l..4l+3 and
//   chunks ((l / 2 + w) % 4) + {0, 4}: both its word loads and its chunk
//   stores are free of bank conflicts.
// - two consumer warpgroups (warps 4-11), each owning 64 * MW rows: one
//   thread keeps the warpgroup's own x tiles in flight by TMA (128-byte
//   swizzle, kStages deep); all issue wgmma.mma_async m64n128k16 with A (x)
//   and B (the dequantized weight) from shared memory, four per K tile, keep
//   one K tile of products in flight, and release a stage on its "empty"
//   barrier once the products that read it completed (wgmma.wait_group).
//   Epilogue: the fp32 accumulators rounded to bf16, stores masked in M and
//   N. TMA's zero fill beyond the tensor's edges takes the place of masked
//   loads: rows past M, columns past N and k past K read zeros.
// The dequantization is the longest chain of dependent instructions here
// and paces the kernel at 256-row tiles (a second producer warpgroup would
// leave the consumers too few registers for two 64-row pieces).
// A wait on an mbarrier that never completes traps after ~2^34 cycles, so
// a broken pipeline fails the launch instead of hanging the card.
//
// Requirements (the wrapper routes every other call to v2): K % 8 == 0 (x
// rows are 16-byte multiples), N % 16 == 0 (weight rows), 16-byte aligned x,
// q and scale, and for int4 a group of a multiple of 8 rows (a 16-byte
// chunk of 8 k values lies in one group).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "sm90_pipeline.cuh"

namespace {

constexpr int BN = 128;  // output columns per block
constexpr int BK = 64;   // k per tile: one 128-byte bf16 row
constexpr int THREADS = 384;
constexpr int kStages = 4;     // x and dequantized weight tiles in the ring
constexpr int kRawStages = 4;  // raw weight tiles in flight
// registers per thread after the split (setmaxnreg): the producer gives up
// what the consumers' accumulators take; 96 + 2 * 200 <= 3 * 168, the
// launch's 168 per thread at 384 threads
constexpr int PRODUCER_REGS = 96;
constexpr int CONSUMER_REGS = 200;
constexpr int B_TILE = BN * BK * 2;  // dequantized tile bytes

// ---------------------------------------------------------------- PTX helpers

using fct::byte_as_float;
using fct::fence_proxy_async;
using fct::kInt4Bias;
using fct::kInt8Bias;
using fct::mbar_arrive;
using fct::mbar_expect_tx;
using fct::mbar_init;
using fct::mbar_wait;
using fct::make_map;
using fct::sw128_desc;
using fct::tma_load_2d;

// d[64 x 128] += A[64 x 16] * B[16 x 128], both K-major in shared memory
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// ---------------------------------------------------------------- kernel

template <bool PACKED, int MW_>
struct Shape {
  static constexpr int MW = MW_;  // 64-row wgmma pieces per consumer warpgroup
  static constexpr int BM = 128 * MW;
  static constexpr int X_HALF = 64 * MW * BK * 2;         // one consumer's x tile
  static constexpr int QROWS = PACKED ? BK / 2 : BK;      // stored weight rows per tile
  static constexpr int RAW_TILE = QROWS * BN;
  static constexpr int X_OFF = 0;
  static constexpr int B_OFF = X_OFF + kStages * 2 * X_HALF;
  static constexpr int R_OFF = B_OFF + kStages * B_TILE;
  static constexpr int BAR_OFF = R_OFF + kRawStages * RAW_TILE;
  static constexpr int N_BARS = 2 * kRawStages + 4 * kStages;
  static constexpr int SMEM = BAR_OFF + N_BARS * 8 + 1024;  // + alignment slack
  static_assert(X_HALF % 1024 == 0 && B_TILE % 1024 == 0 && RAW_TILE % 128 == 0, "alignment");
};

template <bool PACKED, int MW>
__global__ void __launch_bounds__(THREADS, 1) quant_matmul_sm90_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap qmap,
    const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int M, int K, int N, int g,
    int G) {
  using S = Shape<PACKED, MW>;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned base: the swizzle atoms of the x and weight tiles
  const uint32_t base = (fct::smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - fct::smem_u32(smem_raw));
  const uint32_t bars = base + S::BAR_OFF;
  // barrier addresses: raw[kRawStages], x[2][kStages], full[kStages],
  // empty[kStages], raw_empty[kRawStages]
  auto raw_bar = [&](int r) { return bars + 8u * r; };
  auto x_bar = [&](int c, int s) { return bars + 8u * (kRawStages + c * kStages + s); };
  auto full_bar = [&](int s) { return bars + 8u * (kRawStages + 2 * kStages + s); };
  auto empty_bar = [&](int s) { return bars + 8u * (kRawStages + 3 * kStages + s); };
  auto raw_empty_bar = [&](int r) { return bars + 8u * (kRawStages + 4 * kStages + r); };

  const int m0 = blockIdx.x * S::BM, n0 = blockIdx.y * BN;
  const int n_tiles = (K + BK - 1) / BK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int r = 0; r < kRawStages; ++r) {
      mbar_init(raw_bar(r), 1);
      mbar_init(raw_empty_bar(r), 128);  // every producer thread
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(x_bar(0, s), 1);
      mbar_init(x_bar(1, s), 1);
      mbar_init(full_bar(s), 128);   // every producer thread
      mbar_init(empty_bar(s), 256);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int w = tid / 32, l = tid % 32;
    const int n_col = n0 + 4 * l;  // this thread's 4 columns
    const bool col_ok = n_col < N;  // N % 16 == 0: all four or none
    if (tid == 0) {
      for (int r = 0; r < kRawStages && r < n_tiles; ++r) {
        mbar_expect_tx(raw_bar(r), S::RAW_TILE);
        tma_load_2d(base + S::R_OFF + r * S::RAW_TILE, &qmap, raw_bar(r), n0, r * S::QROWS);
      }
    }
    float sc[2][4];
    int cur[2] = {-1, -1};
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int s = kt % kStages, rs = kt % kRawStages;
      if (kt >= kStages) mbar_wait(empty_bar(s), ((kt / kStages) + 1) & 1);
      mbar_wait(raw_bar(rs), (kt / kRawStages) & 1);
      const unsigned char* raw = gbase + S::R_OFF + rs * S::RAW_TILE + 4 * l;
      unsigned char* bt = gbase + S::B_OFF + s * B_TILE;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = (((l >> 1) + w) & 3) | (u << 2);  // 16-byte chunk: k = 8c .. 8c+7
        // per-column int8 scales: one group; rows past K are zeros, any group will do
        const int grp = PACKED ? min((kt * BK + 8 * c) / g, G - 1) : 0;
        if (grp != cur[u]) {
          cur[u] = grp;
          const float4 v = col_ok ? *reinterpret_cast<const float4*>(scale + (long)grp * N + n_col)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
          sc[u][0] = v.x, sc[u][1] = v.y, sc[u][2] = v.z, sc[u][3] = v.w;
        }
        uint32_t r[8];  // k rows 8c..8c+7: four columns as bytes of each
        float bias;
        if constexpr (PACKED) {
          // stored rows 4c..4c+3, each two k rows: low nibble 2i, high 2i+1
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t v =
                *reinterpret_cast<const uint32_t*>(raw + (4 * c + i) * BN) ^ 0x88888888u;
            r[2 * i] = v & 0x0F0F0F0Fu;
            r[2 * i + 1] = (v >> 4) & 0x0F0F0F0Fu;
          }
          bias = kInt4Bias;
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            r[i] = *reinterpret_cast<const uint32_t*>(raw + (8 * c + i) * BN) ^ 0x80808080u;
          }
          bias = kInt8Bias;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float f[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) f[i] = byte_as_float(r[i], j, bias);
          const float a = sc[u][j];
          // the cast point: bf16(float(q) * scale)
          const uint4 chunk = make_uint4(
              fct::pack_bf16(f[0] * a, f[1] * a), fct::pack_bf16(f[2] * a, f[3] * a),
              fct::pack_bf16(f[4] * a, f[5] * a), fct::pack_bf16(f[6] * a, f[7] * a));
          const int n = 4 * l + j;
          *reinterpret_cast<uint4*>(bt + n * 128 + ((c ^ (n & 7)) << 4)) = chunk;
        }
      }
      fence_proxy_async();  // the generic stores, visible to wgmma's async reads
      mbar_arrive(full_bar(s));
      mbar_arrive(raw_empty_bar(rs));  // done reading raw tile kt
      // refill the raw stage of the previous tile once every producer
      // thread is done with it: three tiles of lead, no warpgroup barrier
      const int prev = kt - 1;
      if (tid == 0 && prev >= 0 && prev + kRawStages < n_tiles) {
        const int ps = prev % kRawStages;
        mbar_wait(raw_empty_bar(ps), (prev / kRawStages) & 1);
        fence_proxy_async();
        mbar_expect_tx(raw_bar(ps), S::RAW_TILE);
        tma_load_2d(base + S::R_OFF + ps * S::RAW_TILE, &qmap, raw_bar(ps), n0,
                    (prev + kRawStages) * S::QROWS);
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int cw = tid / 128 - 1, ct = tid % 128;
    const int row0 = m0 + cw * 64 * S::MW;  // this warpgroup's first row
    auto x_tile = [&](int s) { return base + S::X_OFF + (s * 2 + cw) * S::X_HALF; };
    if (ct == 0) {
      for (int s = 0; s < kStages && s < n_tiles; ++s) {
        mbar_expect_tx(x_bar(cw, s), S::X_HALF);
        tma_load_2d(x_tile(s), &xmap, x_bar(cw, s), s * BK, row0);
      }
    }
    float acc[S::MW][64];
#pragma unroll
    for (int p = 0; p < S::MW; ++p) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[p][i] = 0.f;
    }
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int s = kt % kStages;
      const uint32_t ph = (kt / kStages) & 1;
      mbar_wait(x_bar(cw, s), ph);
      mbar_wait(full_bar(s), ph);
      const uint64_t db = sw128_desc(base + S::B_OFF + s * B_TILE);
#pragma unroll
      for (int p = 0; p < S::MW; ++p) fct::fence_regs(acc[p]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int k = 0; k < BK / 16; ++k) {
#pragma unroll
        for (int p = 0; p < S::MW; ++p) {
          // a 16-wide k slice starts 32 bytes further into each swizzled row
          wgmma_m64n128k16(acc[p], sw128_desc(x_tile(s) + p * 64 * BK * 2) + 2 * k, db + 2 * k);
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int p = 0; p < S::MW; ++p) fct::fence_regs(acc[p]);
      // the previous tile's products are done: release its stage
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
      for (int p = 0; p < S::MW; ++p) fct::fence_regs(acc[p]);
      if (kt > 0) {
        const int ps = (kt - 1) % kStages;
        mbar_arrive(empty_bar(ps));
        if (ct == 0 && kt - 1 + kStages < n_tiles) {
          mbar_expect_tx(x_bar(cw, ps), S::X_HALF);
          tma_load_2d(x_tile(ps), &xmap, x_bar(cw, ps), (kt - 1 + kStages) * BK, row0);
        }
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int p = 0; p < S::MW; ++p) fct::fence_regs(acc[p]);

    // accumulator layout of m64nNk16: rows 16 * warp + lane / 4 (+ 8),
    // columns 8 * j + 2 * (lane % 4) (+ 1) of each 8-column piece j
    const int warp = ct / 32, lane = ct % 32;
#pragma unroll
    for (int p = 0; p < S::MW; ++p) {
      const int r_a = row0 + p * 64 + 16 * warp + lane / 4;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * (lane % 4);
        if (col >= N) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = r_a + 8 * half;
          if (row < M) {
            *reinterpret_cast<uint32_t*>(out + (long)row * N + col) =
                fct::pack_bf16(acc[p][4 * j + 2 * half], acc[p][4 * j + 2 * half + 1]);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------- host

template <bool PACKED, int MW>
int launch(const void* x, const void* q, const void* scale, void* out, int M, int K, int N, int G,
           cudaStream_t stream) {
  using S = Shape<PACKED, MW>;
  const int g = K / G;
  // the runtime call first: it makes the device's context current on this
  // thread (a thread that has made no runtime call, as autograd's backward
  // thread, may have none yet), which cuTensorMapEncodeTiled needs
  auto kernel = quant_matmul_sm90_kernel<PACKED, MW>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap xmap, qmap;
  if (!make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, 64 * S::MW, BK,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&qmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q, PACKED ? K / 2 : K, N, S::QROWS, BN,
                CU_TENSOR_MAP_SWIZZLE_NONE)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid((M + S::BM - 1) / S::BM, (N + BN - 1) / BN);
  kernel<<<grid, THREADS, S::SMEM, stream>>>(xmap, qmap, static_cast<const float*>(scale),
                                              static_cast<__nv_bfloat16*>(out), M, K, N, g, G);
  return static_cast<int>(cudaGetLastError());
}

// The tile height: 256 rows (two 64-row pieces per consumer) halve the
// dequantization per product, 128 rows fill more SMs. A 128-row tile takes
// about three quarters of a 256-row tile's time (each dequantizes a whole
// weight tile), so 128 rows win where they need fewer than 4/3 the waves.
template <bool PACKED>
int run(const void* x, const void* q, const void* scale, void* out, int M, int K, int N, int G,
        void* stream) {
  const bool ok = M > 0 && N > 0 && K > 0 && K % 8 == 0 && N % 16 == 0 && G > 0 && K % G == 0 &&
                  (!PACKED || (K / G) % 8 == 0) && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(scale) % 16 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long n_blocks = (N + BN - 1) / BN;
  const long wide_waves = ((M + 255) / 256 * n_blocks + sms - 1) / sms;
  const long narrow_waves = ((M + 127) / 128 * n_blocks + sms - 1) / sms;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (3 * narrow_waves < 4 * wide_waves) {
    return launch<PACKED, 1>(x, q, scale, out, M, K, N, G, st);
  }
  return launch<PACKED, 2>(x, q, scale, out, M, K, N, G, st);
}

}  // namespace

// x bf16 [M, K], q int8 [K, N], scale fp32 [N]; out bf16 [M, N]
extern "C" int quant_matmul_int8_sm90(const void* x, const void* q, const void* scale, void* out,
                                      int M, int K, int N, void* stream) {
  return run<false>(x, q, scale, out, M, K, N, 1, stream);
}

// x bf16 [M, K], q int4 nibbles [K/2, N], scale fp32 [G, N] (group K / G, a
// multiple of 8); out bf16 [M, N]
extern "C" int quant_matmul_int4_sm90(const void* x, const void* q, const void* scale, void* out,
                                      int M, int K, int N, int G, void* stream) {
  return run<true>(x, q, scale, out, M, K, N, G, stream);
}
