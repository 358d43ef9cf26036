// Fused dequant matmul (K8) for Hopper at decode shapes: at most 64 rows of
// x, split-K over a TMA ring of the weight as stored, wgmma with the
// operands swapped and the weight dequantized into register fragments.
//
// Replaces the TPU kernel finchat_tpu/ops/quant_matmul.py _quant_matmul_2d
// (_qmm_kernel, via quant_matmul_int8 and quant_matmul_int4) for calls of at
// most 64 rows whose operands TMA can read: every decode step's seven
// matmuls a layer (M = the engine's slots) and the lm_head with fp32 output,
// at decode and at a prefill chunk's last rows. quant_matmul_sm90.cu serves
// more rows, quant_matmul.cu ("v2") the shapes TMA cannot take. It computes
// what they compute: x bf16 [M, K] times a weight stored as int8 [K, N] with
// per-column fp32 scales [N], or as int4 nibbles [K/2, N] (byte i holds row
// 2i in its low nibble and row 2i+1 in its high nibble, signed) with
// per-group scales [G, N], group g = K / G. Each weight is
// bf16(float(q) * scale[k / g][n]) — the TPU kernel's cast point — the
// products accumulate in fp32, and the output is bf16, or fp32 for the head.
//
// What bounds it on the H100: the weight's bytes, 1 (int8) or 0.5 (int4) a
// weight read once — at M = 64 a [4096, 14336] int8 weight is 58.7 MB
// (17.5 us at 3.35 TB/s) against 7.5 GFLOP (7.6 us at 989 TFLOP/s).
//
// Design.
// - Split K to fill the card. Block (c, s) takes the output columns
//   [128 c, 128 c + 128) over k in [s * k_split, min(K, (s + 1) * k_split)),
//   k_split a multiple of the 64-row K tile picked by the wrapper
//   (ops/quant_matmul.decode_split) so the grid makes one to two waves on
//   the card: a [4096, 1024] weight gives 8 column blocks in 32 splits on
//   132 SMs, the [4096, 128256] head 1002 blocks and no split. With one split
//   a block writes the output itself; with more, each writes its fp32
//   partial [M, N] into its slice of a workspace [splits, M, N], and a second
//   kernel of the same entry point sums the slices in split order. No
//   atomics: two launches on the same inputs give the same bits.
// - A TMA ring of the weight as stored. One producer warp keeps kStages
//   stages in flight on mbarriers; a stage holds one 64-row K tile: the raw
//   weight (64 x 128 bytes int8, 32 x 128 int4) and x's [MP x 64] slice, both
//   with the 128-byte swizzle, and for int4 with groups the tile's scale rows.
//   TMA's zero fill takes the place of masked loads: x's rows past M, k past
//   K and columns past N read zeros.
// - Swapped operands: out^T = W^T x^T on wgmma m64nMPk16, the weight's
//   output columns the 64-row side (A, from registers) and x's rows the
//   narrow side (B, x's swizzled slice in shared memory, K-major), so a call
//   of 4 rows costs an n8 product, not a 64-row tile (MP = M rounded up to
//   8, 16, 32 or 64 is a template argument). The block's 128 columns are two
//   m64 tiles of one consumer warpgroup; their rows are permuted so that
//   thread (g = lane / 4, q = lane % 4) of warp w holds the four columns
//   4 (8 w + g) .. + 3 (tile T's rows g and g + 8 of the warp's 16 are
//   columns + 2T and + 2T + 1): for each of its four k rows of a 16-k step,
//   one 32-bit shared load reads its four columns' bytes, and one byte
//   permute per value both picks the value out and turns it into a float
//   without a conversion instruction (a byte b = q ^ 0x80, or a nibble ^ 8,
//   placed under the exponent of 2^23 reads 2^23 + b exactly; one
//   subtraction leaves the signed value). Each weight is read from shared
//   memory and dequantized once, straight into the A fragments: no
//   dequantized tile is stored, and no thread loads x. The swizzle keeps
//   those loads free of bank conflicts (int8; int4 is 2-way). The products
//   of half a tile run asynchronously while the warpgroup dequantizes the
//   next half to fp32; only the rounding to bf16, after the wait, writes the
//   fragments a product reads. A stage is released once the products that
//   read its x have completed.
// A wait on an mbarrier that never completes traps after ~2^34 cycles, so a
// broken pipeline fails the launch instead of hanging the card.
//
// Diagnostic builds (tools/qmm_decode_diag.py; the result is garbage):
// -DFCT_QMM_NO_FETCH (no TMA: the ring is read as it stands),
// -DFCT_QMM_NO_PRODUCTS (fragments read and converted, no wgmma),
// -DFCT_QMM_NO_REDUCE (no second kernel), -DFCT_QMM_NO_DEQUANT (the ring
// streams, nothing reads it).
//
// Requirements (the wrapper routes every other call elsewhere): 1 <= M <=
// 64, K % 8 == 0 (x rows are 16-byte multiples), N % 16 == 0 (weight rows),
// 16-byte aligned x, q, scale and workspace, and for int4 a group of a
// multiple of 8 rows (each 8-row half of a 16-k step lies in one group).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "sm90_pipeline.cuh"

namespace {

constexpr int BN = 128;               // output columns per block
constexpr int BK = 64;                // k per tile: one 128-byte row of x
constexpr int CWARPS = BN / 32;       // consumer warps (one warpgroup), 32 columns each
constexpr int THREADS = 32 * (CWARPS + 1);  // and a producer warp
constexpr int kStages = 4;

using fct::byte_as_float;
using fct::kInt4Bias;
using fct::kInt8Bias;
using fct::make_map;
using fct::mbar_arrive;
using fct::mbar_expect_tx;
using fct::mbar_init;
using fct::mbar_wait;
using fct::tma_load_2d;

// d[64 x N] += A[64 x 16] * B[16 x N]: A from registers (the m16n8k16 A
// fragment of each warp's 16 rows), B = x^T K-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<8>(float (&d)[4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3},"
      " {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7},"
      " {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the four columns' bytes at the 16-k step ks's k rows 16 ks + 2 q + {0, 1,
// 8, 9} of a raw weight tile, dequantized to fp32 (float(q) * scale): v[4 j
// + e] is column n + j at k row e of the four
template <bool PACKED>
__device__ __forceinline__ void dequant_step(const unsigned char* raw, int ks, int q, int chunk,
                                             int word, const float (&lo)[4], const float (&hi)[4],
                                             float (&v)[16]) {
  // u[e]: the four columns at k row e, bytes b of value b - bias
  uint32_t u[4];
  float bias;
  if constexpr (PACKED) {
    // stored rows 8 ks + q and 8 ks + q + 4: low nibbles k = 2r, high 2r + 1
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 8 * ks + q + 4 * e;
      const uint32_t w =
          *reinterpret_cast<const uint32_t*>(raw + r * 128 + (((chunk ^ (r & 7)) << 4) | word)) ^
          0x88888888u;
      u[2 * e] = w & 0x0F0F0F0Fu;
      u[2 * e + 1] = (w >> 4) & 0x0F0F0F0Fu;
    }
    bias = kInt4Bias;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * ks + 2 * q + (e & 1) + 8 * (e >> 1);
      u[e] = *reinterpret_cast<const uint32_t*>(raw + r * 128 + (((chunk ^ (r & 7)) << 4) | word)) ^
             0x80808080u;
    }
    bias = kInt8Bias;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[4 * j + e] = byte_as_float(u[e], j, bias) * (e < 2 ? lo[j] : hi[j]);
    }
  }
}

// v rounded to bf16 — the cast point bf16(float(q) * scale) — into the A
// fragments of the two m64 tiles: tile T's row gq of the warp's 16 is column
// n + 2T, row gq + 8 column n + 2T + 1; registers (row gq, k 2q..2q+1),
// (row gq + 8, ..), (row gq, k 2q+8..), (row gq + 8, ..)
__device__ __forceinline__ void pack_step(const float (&v)[16], uint32_t (&a)[2][4]) {
#pragma unroll
  for (int t = 0; t < 2; ++t) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * t + h;
      a[t][h] = fct::pack_bf16(v[4 * j], v[4 * j + 1]);
      a[t][2 + h] = fct::pack_bf16(v[4 * j + 2], v[4 * j + 3]);
    }
  }
}

// out [M, N] (or slice blockIdx.y of the workspace) = x [M, K] @ dequant(W)
// over the block's columns and K range
template <bool PACKED, bool GROUPED, int MP, bool OUT_BF16>
__global__ void __launch_bounds__(THREADS, 2) quant_matmul_decode_sm90_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap smap, const float* __restrict__ scale,
    void* __restrict__ out, int M, int K, int N, int g, int k_split, int sr, int stage_bytes) {
  constexpr int RAW = (PACKED ? BK / 2 : BK) * BN;  // raw weight tile bytes
  constexpr int XT = MP * BK * 2;                   // x slice bytes
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned base: the 128-byte swizzle's atoms
  const uint32_t base = (fct::smem_u32(smem_raw) + 1023u) & ~1023u;
  const unsigned char* const gbase = smem_raw + (base - fct::smem_u32(smem_raw));
  const uint32_t bars = base + kStages * stage_bytes;
  auto full_bar = [&](int s) { return bars + 8u * s; };
  auto empty_bar = [&](int s) { return bars + 8u * (kStages + s); };

  const int n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.y * k_split;
  const int n_tiles = (min(K, k_begin + k_split) - k_begin + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), CWARPS);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CWARPS) {
    // ------------------------------------------------------------ producer
    if (lane == 0) {
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) {
          mbar_wait(empty_bar(s), ((t / kStages) + 1) & 1);
          fct::fence_proxy_async();
        }
#ifdef FCT_QMM_NO_FETCH
        mbar_arrive(full_bar(s));
#else
        const uint32_t st = base + s * stage_bytes;
        const int k0 = k_begin + t * BK;
        mbar_expect_tx(full_bar(s), RAW + XT + (GROUPED ? sr * BN * 4 : 0));
        tma_load_2d(st, &qmap, full_bar(s), n0, PACKED ? k0 / 2 : k0);
        tma_load_2d(st + RAW, &xmap, full_bar(s), k0, 0);
        if constexpr (GROUPED) tma_load_2d(st + RAW + XT, &smap, full_bar(s), n0, k0 / g);
#endif
      }
    }
    return;
  }

  // --------------------------------------------- consumers: one warpgroup
  const int gq = lane / 4, q = lane % 4;
  const int f = 8 * warp + gq;  // this thread's 4-byte word of a weight row
  const int n = n0 + 4 * f;     // its columns n .. n + 3
  // the word's place in a swizzled 128-byte row: 16-byte chunk f / 4
  // (stored at chunk ^ row % 8), byte 4 (f % 4) of the chunk
  const int chunk = f >> 2, word = (f & 3) << 2;
  float sc[4] = {0.f, 0.f, 0.f, 0.f};  // per-column scales (one group)
  if constexpr (!GROUPED) {
    if (n < N) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(scale + n));
      sc[0] = v.x, sc[1] = v.y, sc[2] = v.z, sc[3] = v.w;
    }
  }
  float acc[2][MP / 2];  // the two m64 tiles' accumulators
#pragma unroll
  for (int t = 0; t < 2; ++t) {
#pragma unroll
    for (int i = 0; i < MP / 2; ++i) acc[t][i] = 0.f;
  }
#ifdef FCT_QMM_NO_PRODUCTS
  uint32_t sink = 0;
#endif

  // Half a tile (two 16-k steps) at a time: dequantize it to fp32 while the
  // previous half's products run, wait for them, then round to bf16 into
  // the A fragments and issue this half's four products. Only that rounding
  // writes registers a product reads, and only while no product runs, so
  // ptxas need not serialize the products (C7513).
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    mbar_wait(full_bar(s), (t / kStages) & 1);
#ifdef FCT_QMM_NO_DEQUANT
    if (t > 0 && lane == 0) mbar_arrive(empty_bar((t - 1) % kStages));
    continue;
#endif
    const unsigned char* const raw = gbase + s * stage_bytes;
    const uint64_t db = fct::sw128_desc(base + s * stage_bytes + RAW);
    const int k0 = k_begin + t * BK;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float v[2][16];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int ks = 2 * half + kk;
        // the scales of the step's two 8-row halves, k0 + 16 ks and + 8
        float lo[4], hi[4];
        if constexpr (GROUPED) {
          const unsigned char* srow = raw + RAW + XT + 16 * f;
          const int g0 = k0 / g;
          const float4 x0 =
              *reinterpret_cast<const float4*>(srow + ((k0 + 16 * ks) / g - g0) * BN * 4);
          const float4 x1 =
              *reinterpret_cast<const float4*>(srow + ((k0 + 16 * ks + 8) / g - g0) * BN * 4);
          lo[0] = x0.x, lo[1] = x0.y, lo[2] = x0.z, lo[3] = x0.w;
          hi[0] = x1.x, hi[1] = x1.y, hi[2] = x1.z, hi[3] = x1.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) lo[j] = hi[j] = sc[j];
        }
        dequant_step<PACKED>(raw, ks, q, chunk, word, lo, hi, v[kk]);
      }
#ifdef FCT_QMM_NO_PRODUCTS
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t a[2][4];
        pack_step(v[kk], a);
#pragma unroll
        for (int i = 0; i < 4; ++i) sink ^= a[0][i] ^ a[1][i];
      }
      if (half == 0 && t > 0 && lane == 0) mbar_arrive(empty_bar((t - 1) % kStages));
#else
      // the previous half's products are done: their registers, and at a
      // tile's start the previous tile's stage, are free (the fences keep
      // the dequantization before the wait and the rounding after it)
      fct::fence_regs(v[0]);
      fct::fence_regs(v[1]);
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fct::fence_regs(acc[0]);
      fct::fence_regs(acc[1]);
      fct::fence_regs(v[0]);
      fct::fence_regs(v[1]);
      if (half == 0 && t > 0 && lane == 0) mbar_arrive(empty_bar((t - 1) % kStages));
      uint32_t a[2][2][4];
      pack_step(v[0], a[0]);
      pack_step(v[1], a[1]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        // a 16-wide k slice starts 32 bytes further into each swizzled row
        wgmma_rs<MP>(acc[0], a[kk][0], db + 2 * (2 * half + kk));
        wgmma_rs<MP>(acc[1], a[kk][1], db + 2 * (2 * half + kk));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
#endif
    }
  }
#ifdef FCT_QMM_NO_PRODUCTS
  acc[0][0] += __uint_as_float(sink & 0x007FFFFFu);
#else
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fct::fence_regs(acc[0]);
  fct::fence_regs(acc[1]);
#endif

  // accumulator of m64nMP: (row gq, x rows 8 j + 2 q, + 1) at [4 j], [4 j + 1],
  // (row gq + 8, ..) at [4 j + 2], [4 j + 3]: the thread holds out[m][n + 2T + h]
  // for m = 8 j + 2 q + i at acc[T][4 j + 2 h + i]
  if (n >= N) return;  // N % 16 == 0: all four columns or none
#pragma unroll
  for (int j = 0; j < MP / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = 8 * j + 2 * q + i;
      if (m >= M) continue;
      const float v0 = acc[0][4 * j + i], v1 = acc[0][4 * j + 2 + i];
      const float v2 = acc[1][4 * j + i], v3 = acc[1][4 * j + 2 + i];
      if constexpr (OUT_BF16) {
        *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + (long)m * N + n) =
            make_uint2(fct::pack_bf16(v0, v1), fct::pack_bf16(v2, v3));
      } else {
        float* const o = static_cast<float*>(out) + (long)blockIdx.y * M * N;
        *reinterpret_cast<float4*>(o + (long)m * N + n) = make_float4(v0, v1, v2, v3);
      }
    }
  }
}

// out [M, N] = the sum of the workspace's splits [splits, M, N] in split
// order, four values a thread
template <bool OUT_BF16>
__global__ void __launch_bounds__(256) quant_matmul_decode_reduce(
    const float4* __restrict__ ws, void* __restrict__ out, long n4, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const float4* p = ws + i;
  float4 a = *p;
  for (int s = 1; s < splits; ++s) {
    p += n4;
    const float4 v = *p;
    a.x += v.x, a.y += v.y, a.z += v.z, a.w += v.w;
  }
  if constexpr (OUT_BF16) {
    __nv_bfloat162* const o = static_cast<__nv_bfloat162*>(out) + 2 * i;
    o[0] = __floats2bfloat162_rn(a.x, a.y);
    o[1] = __floats2bfloat162_rn(a.z, a.w);
  } else {
    static_cast<float4*>(out)[i] = a;
  }
}

// ---------------------------------------------------------------- host

// the most scale groups of g rows that one 64-row K tile starting at a
// multiple of 64 spans
int scale_rows(int g) {
  int a = g, b = BK;
  while (b != 0) {
    const int r = a % b;
    a = b, b = r;
  }
  int most = 1;
  for (long i = 0; i < g / a; ++i) {  // tile starts repeat with period lcm(g, 64)
    const long k0 = BK * i;
    most = max(most, (int)((k0 + BK - 1) / g - k0 / g + 1));
  }
  return most;
}

// the operands' TMA maps: x [M, K] in boxes of MP x 64, the weight's K tile,
// and the int4 scale rows of a tile where grouped
template <bool PACKED, bool GROUPED, int MP>
bool make_maps(CUtensorMap* xmap, CUtensorMap* qmap, CUtensorMap* smap, const void* x,
               const void* q, const void* scale, int M, int K, int N, int G, int sr) {
  return make_map(xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, MP, BK,
                  CU_TENSOR_MAP_SWIZZLE_128B) &&
         make_map(qmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q, PACKED ? K / 2 : K, N,
                  PACKED ? BK / 2 : BK, BN, CU_TENSOR_MAP_SWIZZLE_128B) &&
         (!GROUPED || make_map(smap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, scale, G, N, sr, BN,
                               CU_TENSOR_MAP_SWIZZLE_NONE));
}

template <bool PACKED, bool GROUPED, int MP>
cudaError_t launch_body(const void* x, const void* q, const float* scale, void* dst,
                        bool out_bf16, int M, int K, int N, int G, int g, int splits,
                        int k_split, int sr, cudaStream_t stream) {
  constexpr int RAW = (PACKED ? BK / 2 : BK) * BN;
  const int stage_bytes = (RAW + MP * BK * 2 + (GROUPED ? sr * BN * 4 : 0) + 1023) / 1024 * 1024;
  const int smem = kStages * stage_bytes + 2 * kStages * 8 + 1024;  // + alignment slack
  auto kernel = out_bf16 ? quant_matmul_decode_sm90_kernel<PACKED, GROUPED, MP, true>
                         : quant_matmul_decode_sm90_kernel<PACKED, GROUPED, MP, false>;
  // the runtime call first: it makes the device's context current on this
  // thread (a thread that has made no runtime call, as autograd's backward
  // thread, may have none yet), which cuTensorMapEncodeTiled needs
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  CUtensorMap xmap, qmap, smap = {};
  if (!make_maps<PACKED, GROUPED, MP>(&xmap, &qmap, &smap, x, q, scale, M, K, N, G, sr)) {
    return cudaErrorInvalidValue;
  }
  dim3 grid((N + BN - 1) / BN, splits);
  kernel<<<grid, THREADS, smem, stream>>>(xmap, qmap, smap, scale, dst, M, K, N, g, k_split, sr,
                                          stage_bytes);
  return cudaGetLastError();
}

template <bool PACKED, bool GROUPED>
cudaError_t launch_rows(const void* x, const void* q, const float* scale, void* dst,
                        bool out_bf16, int MP, int M, int K, int N, int G, int g, int splits,
                        int k_split, int sr, cudaStream_t st) {
  switch (MP) {
    case 8:
      return launch_body<PACKED, GROUPED, 8>(x, q, scale, dst, out_bf16, M, K, N, G, g, splits,
                                             k_split, sr, st);
    case 16:
      return launch_body<PACKED, GROUPED, 16>(x, q, scale, dst, out_bf16, M, K, N, G, g, splits,
                                              k_split, sr, st);
    case 32:
      return launch_body<PACKED, GROUPED, 32>(x, q, scale, dst, out_bf16, M, K, N, G, g, splits,
                                              k_split, sr, st);
    default:
      return launch_body<PACKED, GROUPED, 64>(x, q, scale, dst, out_bf16, M, K, N, G, g, splits,
                                              k_split, sr, st);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// the plan (splits, k_split) comes from the wrapper: split s covers k in
// [s * k_split, min(K, (s + 1) * k_split)), every split non-empty
template <bool PACKED>
int run(const void* x, const void* q, const void* scale, void* out, void* ws, int M, int K, int N,
        int G, int out_f32, int splits, int k_split, void* stream) {
  const bool ok = M >= 1 && M <= 64 && K > 0 && N > 0 && N <= (1 << 24) && K % 8 == 0 &&
                  N % 16 == 0 && G > 0 && K % G == 0 && (PACKED ? (K / G) % 8 == 0 : G == 1) &&
                  aligned16(x) && aligned16(q) && aligned16(scale) && splits >= 1 &&
                  k_split > 0 && k_split % BK == 0 && (long)(splits - 1) * k_split < K &&
                  (long)splits * k_split >= K && (splits == 1 || (ws != nullptr && aligned16(ws)));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int g = K / G;
  const bool grouped = PACKED && G > 1;
  const int sr = grouped ? scale_rows(g) : 0;
  const int MP = M <= 8 ? 8 : M <= 16 ? 16 : M <= 32 ? 32 : 64;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* sp = static_cast<const float*>(scale);
  void* dst = splits > 1 ? ws : out;
  const bool out_bf16 = splits == 1 && !out_f32;
  cudaError_t err;
  if constexpr (PACKED) {
    err = grouped ? launch_rows<true, true>(x, q, sp, dst, out_bf16, MP, M, K, N, G, g, splits,
                                            k_split, sr, st)
                  : launch_rows<true, false>(x, q, sp, dst, out_bf16, MP, M, K, N, G, g, splits,
                                             k_split, sr, st);
  } else {
    err = launch_rows<false, false>(x, q, sp, dst, out_bf16, MP, M, K, N, G, g, splits, k_split,
                                    sr, st);
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
#ifndef FCT_QMM_NO_REDUCE
  const long n4 = (long)M * N / 4;  // < 2^28 (M <= 64, N <= 2^24): a thread's int index
  const auto* w4 = static_cast<const float4*>(ws);
  const unsigned blocks = (unsigned)((n4 + 255) / 256);
  if (out_f32) {
    quant_matmul_decode_reduce<false><<<blocks, 256, 0, st>>>(w4, out, n4, splits);
  } else {
    quant_matmul_decode_reduce<true><<<blocks, 256, 0, st>>>(w4, out, n4, splits);
  }
  err = cudaGetLastError();
#endif
  return static_cast<int>(err);
}

}  // namespace

// x bf16 [M, K], q int8 [K, N], scale fp32 [N]; out bf16 or fp32 [M, N];
// ws fp32 [splits, M, N] (unused with one split)
extern "C" int quant_matmul_int8_decode_sm90(const void* x, const void* q, const void* scale,
                                             void* out, void* ws, int M, int K, int N,
                                             int out_f32, int splits, int k_split, void* stream) {
  return run<false>(x, q, scale, out, ws, M, K, N, 1, out_f32, splits, k_split, stream);
}

// x bf16 [M, K], q int4 nibbles [K/2, N], scale fp32 [G, N] (group K / G, a
// multiple of 8); out and ws as above
extern "C" int quant_matmul_int4_decode_sm90(const void* x, const void* q, const void* scale,
                                             void* out, void* ws, int M, int K, int N, int G,
                                             int out_f32, int splits, int k_split, void* stream) {
  return run<true>(x, q, scale, out, ws, M, K, N, G, out_f32, splits, k_split, stream);
}
