// Fused dequant matmul (K8) for Hopper: y = x @ dequant(q, scale), int8 or
// nibble-packed int4 weights.
//
// Replaces the TPU kernel finchat_tpu/ops/quant_matmul.py _quant_matmul_2d
// (_qmm_kernel, via quant_matmul_int8 and quant_matmul_int4): x bf16 [M, K]
// times a weight stored as int8 [K, N] with per-column fp32 scales [1, N], or
// as int4 nibbles [K/2, N] (byte i holds row 2i in its low nibble and row 2i+1
// in its high nibble, signed) with per-group scales [G, N], group g = K / G.
// The represented weight is bf16(float(q) * scale[k / g][n]) — the TPU
// kernel's cast point — and the product accumulates in fp32; the output is
// bf16, or fp32 for the lm_head.
//
// What bounds it on the H100: at decode (M = 64 rows) the weight bytes —
// 1 byte (int8) or half a byte (int4) per weight, read once; at a prefill
// chunk (M = 2048) the bf16 tensor-core operations (2 * M * K * N).
//
// Design: one block per (BM = 64 or 128 rows) x (BN = 128 columns) output
// tile, BM/16 warps each owning a 32 x 64 piece of it, a loop over K in
// tiles of BK = 64. Each K tile of x and of the weight is loaded from device
// memory into registers as stored (16 bytes a thread), then written to one
// of two shared-memory buffers: x as it is, the weight dequantized to bf16.
// The next tile's loads are issued, and its buffer filled, while the warps
// run ldmatrix + mma.sync m16n8k16 bf16 -> fp32 on the current one: one
// barrier per K tile. Integers become floats without a conversion
// instruction: a byte b (b ^ 0x80 for int8, a nibble ^ 8 for int4) placed
// under the exponent of 2^23 reads 2^23 + b exactly, and one subtraction
// leaves the signed value — two byte permutes and an add in place of the
// slow int-to-float unit. Edges in M, N and K are masked in the kernel
// (zeros in, nothing out); rows and columns that are not 16-byte aligned
// load element by element. It serves the calls the Hopper kernels do not
// take (ops/quant_matmul.kernel_for): rows or weights that are not 16-byte
// multiples or not aligned, int4 groups of fewer than 8 rows, and more than
// 64 rows with fp32 output; quant_matmul_decode_sm90.cu splits K for the
// aligned calls of at most 64 rows, where this grid of N/128 blocks leaves
// most of the card idle.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int BN = 128;       // output columns per block
constexpr int BK = 64;        // K per staged tile
constexpr int XST = BK + 8;   // x tile row stride in bf16 (ldmatrix rows on distinct banks)
constexpr int WST = BN + 8;   // weight tile row stride in bf16
constexpr int WTM = 32;       // rows per warp
constexpr int WTN = 64;       // columns per warp

// two buffers of the x tile and the dequantized weight tile
constexpr size_t smem_bytes(int BM) { return 2 * ((size_t)BM * XST + (size_t)BK * WST) * 2; }

// the four bytes of u (each an unsigned value v < 256) as exact floats v - bias_v
__device__ __forceinline__ void bytes_to_floats(uint32_t u, float bias, float (&f)[4]) {
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - bias;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - bias;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - bias;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - bias;
}

constexpr float kInt8Bias = 8388608.f + 128.f;  // 2^23 + the 0x80 offset
constexpr float kInt4Bias = 8388608.f + 8.f;    // 2^23 + the 8 offset

template <int BM, bool PACKED, bool OUT_F32>
__global__ void __launch_bounds__(BM * 2) quant_matmul_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ scale, void* __restrict__ out, int M, int K, int N, int g,
    int x_vec, int q_vec) {
  constexpr int THREADS = BM * 2;
  constexpr int WARPS_N = BN / WTN;
  constexpr int XPT = BM * BK / 8 / THREADS;         // x chunks (8 bf16) per thread
  constexpr int QROWS = PACKED ? BK / 2 : BK;        // stored weight rows per tile
  constexpr int QPT = QROWS * BN / 16 / THREADS;     // weight chunks (16 bytes) per thread
  static_assert(XPT * THREADS * 8 == BM * BK, "x tile split");
  static_assert(QPT * THREADS * 16 == QROWS * BN, "weight tile split");
  static_assert((BM / WTM) * WARPS_N * 32 == THREADS, "warp tiling");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* const bufs = reinterpret_cast<__nv_bfloat16*>(smem);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int q_rows = PACKED ? K / 2 : K;
  const int G = K / g;
  // a thread's weight chunks share one 16-column slice of the tile
  const int wc = tid % (BN / 16);
  const int n_w = n0 + wc * 16;

  uint4 xr[XPT], qr[QPT];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int idx = tid + i * THREADS;
      const int m = m0 + idx / (BK / 8), k = k0 + (idx % (BK / 8)) * 8;
      if (m < M && k + 8 <= K && x_vec) {
        xr[i] = *reinterpret_cast<const uint4*>(x + (long)m * K + k);
      } else {
        alignas(16) __nv_bfloat16 v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          v[j] = (m < M && k + j < K) ? x[(long)m * K + k + j] : __float2bfloat16(0.f);
        }
        xr[i] = *reinterpret_cast<const uint4*>(v);
      }
    }
    const int kq0 = PACKED ? k0 / 2 : k0;
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      const int kr = kq0 + (tid + i * THREADS) / (BN / 16);
      if (kr < q_rows && n_w + 16 <= N && q_vec) {
        qr[i] = *reinterpret_cast<const uint4*>(q + (long)kr * N + n_w);
      } else {
        alignas(16) int8_t v[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          v[j] = (kr < q_rows && n_w + j < N) ? q[(long)kr * N + n_w + j] : 0;
        }
        qr[i] = *reinterpret_cast<const uint4*>(v);
      }
    }
  };

  // scales of this thread's 16 columns for the group `cur`, reloaded when a
  // chunk's rows enter another group (never, for per-column int8 scales)
  float sc[16];
  int cur = -1;
  auto scales_for = [&](int k) {
    const int grp = min(k / g, G - 1);  // rows past K hold zeros; any group will do
    if (grp != cur) {
      cur = grp;
#pragma unroll
      for (int j = 0; j < 16; ++j) sc[j] = n_w + j < N ? scale[(long)grp * N + n_w + j] : 0.f;
    }
  };

  // 16 values (4 words of 4 bytes) times their column scales, rounded to
  // bf16 — the cast point bf16(float(q) * scale) — into one tile row
  auto put_row = [&](__nv_bfloat16* row, const uint32_t (&u)[4], float bias) {
    uint32_t w[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float f[4];
      bytes_to_floats(u[i], bias, f);
      w[2 * i] = fct::pack_bf16(f[0] * sc[4 * i], f[1] * sc[4 * i + 1]);
      w[2 * i + 1] = fct::pack_bf16(f[2] * sc[4 * i + 2], f[3] * sc[4 * i + 3]);
    }
    uint4* d = reinterpret_cast<uint4*>(row + wc * 16);
    d[0] = make_uint4(w[0], w[1], w[2], w[3]);
    d[1] = make_uint4(w[4], w[5], w[6], w[7]);
  };

  auto store = [&](int k0, int buf) {
    __nv_bfloat16* Xs = bufs + buf * (BM * XST + BK * WST);
    __nv_bfloat16* Ws = Xs + BM * XST;
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int idx = tid + i * THREADS;
      *reinterpret_cast<uint4*>(Xs + (idx / (BK / 8)) * XST + (idx % (BK / 8)) * 8) = xr[i];
    }
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      const int r = (tid + i * THREADS) / (BN / 16);  // stored row within the tile
      const uint32_t words[4] = {qr[i].x, qr[i].y, qr[i].z, qr[i].w};
      if constexpr (PACKED) {
        // rows 2r and 2r+1 share a group (g is even). Nibble ^ 8 is the
        // signed nibble + 8: the low nibbles are row 2r, the high row 2r+1
        scales_for(k0 + 2 * r);
        uint32_t lo[4], hi[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t u = words[j] ^ 0x88888888u;
          lo[j] = u & 0x0F0F0F0Fu;
          hi[j] = (u >> 4) & 0x0F0F0F0Fu;
        }
        put_row(Ws + (2 * r) * WST, lo, kInt4Bias);
        put_row(Ws + (2 * r + 1) * WST, hi, kInt4Bias);
      } else {
        scales_for(k0 + r);
        const uint32_t u[4] = {words[0] ^ 0x80808080u, words[1] ^ 0x80808080u,
                               words[2] ^ 0x80808080u, words[3] ^ 0x80808080u};
        put_row(Ws + r * WST, u, kInt8Bias);
      }
    }
  };

  float acc[2][WTN / 8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int n = 0; n < WTN / 8; ++n) {
      acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;
    }
  }

  const int mi = lane / 8, rr = lane % 8;
  const int n_tiles = (K + BK - 1) / BK;
  load(0);
  store(0, 0);
  __syncthreads();
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_tiles) load((kt + 1) * BK);  // in flight during the products
    const __nv_bfloat16* Xs = bufs + buf * (BM * XST + BK * WST);
    const __nv_bfloat16* Ws = Xs + BM * XST;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        fct::ldsm_x4(a[i], fct::smem_u32(Xs + (wm * WTM + i * 16 + lane % 16) * XST + ks * 16 +
                                         (lane / 16) * 8));
      }
#pragma unroll
      for (int n2 = 0; n2 < WTN / 16; ++n2) {
        uint32_t b[4];
        fct::ldsm_x4_trans(b, fct::smem_u32(Ws + (ks * 16 + (mi % 2) * 8 + rr) * WST +
                                            wn * WTN + n2 * 16 + (mi / 2) * 8));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          fct::mma_bf16(acc[i][2 * n2], a[i], b[0], b[1]);
          fct::mma_bf16(acc[i][2 * n2 + 1], a[i], b[2], b[3]);
        }
      }
    }
    // the other buffer was last read before the previous barrier
    if (kt + 1 < n_tiles) store((kt + 1) * BK, buf ^ 1);
    __syncthreads();
  }

  // C fragment: rows lane/4 and lane/4 + 8 of each 16-row piece, columns
  // 2*(lane%4) + {0, 1} of each 8-column piece
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r_a = m0 + wm * WTM + i * 16 + lane / 4;
#pragma unroll
    for (int n = 0; n < WTN / 8; ++n) {
      const int col = n0 + wn * WTN + n * 8 + 2 * (lane % 4);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r_a + 8 * half;
        if (row >= M) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (col + e >= N) continue;
          const float val = acc[i][n][2 * half + e];
          if constexpr (OUT_F32) {
            static_cast<float*>(out)[(long)row * N + col + e] = val;
          } else {
            static_cast<__nv_bfloat16*>(out)[(long)row * N + col + e] = __float2bfloat16(val);
          }
        }
      }
    }
  }
}

template <int BM, bool PACKED, bool OUT_F32>
cudaError_t launch_bm(const __nv_bfloat16* x, const int8_t* q, const float* scale, void* out,
                      int M, int K, int N, int g, int x_vec, int q_vec, cudaStream_t stream) {
  auto kernel = quant_matmul_kernel<BM, PACKED, OUT_F32>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes(BM));
  if (err != cudaSuccess) return err;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, BM * 2, smem_bytes(BM), stream>>>(x, q, scale, out, M, K, N, g, x_vec, q_vec);
  return cudaGetLastError();
}

template <bool PACKED, bool OUT_F32>
cudaError_t launch(const void* x, const void* q, const void* scale, void* out, int M, int K,
                   int N, int g, int x_vec, int q_vec, cudaStream_t stream) {
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* qp = static_cast<const int8_t*>(q);
  const auto* sp = static_cast<const float*>(scale);
  if (M <= 64) return launch_bm<64, PACKED, OUT_F32>(xp, qp, sp, out, M, K, N, g, x_vec, q_vec,
                                                     stream);
  return launch_bm<128, PACKED, OUT_F32>(xp, qp, sp, out, M, K, N, g, x_vec, q_vec, stream);
}

template <bool PACKED>
int run(const void* x, const void* q, const void* scale, void* out, int M, int K, int N, int g,
        int out_f32, int x_vec, int q_vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      out_f32 ? launch<PACKED, true>(x, q, scale, out, M, K, N, g, x_vec, q_vec, st)
              : launch<PACKED, false>(x, q, scale, out, M, K, N, g, x_vec, q_vec, st);
  return static_cast<int>(err);
}

}  // namespace

// x bf16 [M, K], q int8 [K, N], scale fp32 [N]
extern "C" int quant_matmul_int8(const void* x, const void* q, const void* scale, void* out,
                                 int M, int K, int N, int out_f32, int x_vec, int q_vec,
                                 void* stream) {
  return run<false>(x, q, scale, out, M, K, N, K, out_f32, x_vec, q_vec, stream);
}

// x bf16 [M, K], q int4 nibbles [K/2, N], scale fp32 [G, N] (group K / G)
extern "C" int quant_matmul_int4(const void* x, const void* q, const void* scale, void* out,
                                 int M, int K, int N, int G, int out_f32, int x_vec, int q_vec,
                                 void* stream) {
  if (G <= 0 || K % G != 0 || (K / G) % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return run<true>(x, q, scale, out, M, K, N, K / G, out_f32, x_vec, q_vec, stream);
}
