// Contiguous flash attention for Hopper (K7), forward and backward.
//
// Replaces the TPU kernel finchat_tpu/ops/flash_attention.py flash_attention
// (_flash_kernel): causal or non-causal GQA attention of q [B, Sq, H, D] over
// k, v [B, Sk, Hkv, D], all bf16; query row i of sequence b sits at
// q_offset[b] + i (causal mode) and keys at or past kv_len[b] are masked. The
// JAX package has no backward for its kernel; this file adds one, in the
// flash-attention-2 form, so training runs through the kernel.
//
// What bounds it on the H100: operations. At the training shape (S = 2048,
// 32 heads, head_dim 128, causal) the forward does 4 * H * D * S^2 / 2 = 34
// GFLOP on 25 MB of inputs and outputs, some 1,400 FLOP per byte against the
// card's ~295: the tensor cores are the limit, and the backward does 2.5x the
// forward's products.
//
// Design. Every product runs on tensor cores as mma.sync m16n8k16 bf16 with
// fp32 accumulation (mma.cuh); tiles are staged in shared memory with a
// padded row stride of 136 elements so that ldmatrix rows hit distinct banks.
// Blocks are 4 warps; a warp owns 16 rows of its block's 64.
// - Forward, one block per (64-row query tile, query head, sequence): Q
//   stays in registers, 64-key K and V tiles of the head's KV head are staged
//   in turn (tiles wholly in the causal future or past kv_len are never
//   read), online softmax in fp32, P rounded to bf16 before P V as the
//   reference rounds its weights to the value dtype. Writes the bf16 output
//   (acc / max(l, 1e-30): a row with no valid key writes zeros) and the row's
//   log-sum-exp m + log(l) (-inf for a row with no valid key).
// - Backward, three kernels in a row on the caller's stream (no atomics, so
//   the result is deterministic):
//   1. delta[b, h, i] = sum_d dout * out, one warp per row;
//   2. dK, dV per (64-key tile, KV head, sequence): the block loops over the
//      group's query heads and the 32-row query tiles the causal mask lets
//      see its keys, rebuilds P^T = exp(scale K Q^T - lse), and accumulates
//      dV += bf16(P^T) dout and dK += bf16(dS^T) Q in registers, with
//      dS = P (dP - delta), dP^T = V dout^T; the GQA sum over query heads
//      happens in the accumulator;
//   3. dQ per (64-row query tile, query head, sequence): the same P and dS,
//      dQ += bf16(dS) K over the needed key tiles.
// TMA and wgmma are for a later version; this one is simple and right first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using fct::ldsm_x4;
using fct::ldsm_x4_trans;
using fct::mma_bf16;
using fct::pack_bf16;
using fct::smem_u32;

constexpr int D = 128;       // head_dim the kernels are built for
constexpr int ST = 136;      // shared-memory row stride in bf16 elements (128 + 8)
constexpr int NT = 128;      // threads per block: 4 warps
constexpr int BR = 64;       // query rows per forward / dQ block
constexpr int BC = 64;       // keys per tile
constexpr int BQ = 32;       // query rows per staged tile of the dK/dV kernel
constexpr int C8 = D / 8;    // 16-byte chunks per row

struct Dims {
  int B, Sq, Sk, H, HKV, causal;
  float scale;
};

// Copy `rows` rows of D bf16 values (row r at src + r * stride) into a
// shared tile of row stride ST; rows at or past n are zeros.
__device__ __forceinline__ void stage(bf16* dst, const bf16* __restrict__ src, long stride,
                                      int rows, int n) {
  for (int idx = threadIdx.x; idx < rows * C8; idx += NT) {
    const int r = idx / C8, c = idx % C8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < n) v = *reinterpret_cast<const uint4*>(src + (long)r * stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * ST + c * 8) = v;
  }
}

// c[0..NJ) += A (16 rows of `a_tile`, starting at its row a_row0, all D
// columns) times B^T, where B is rows [0, 8 * NJ) of `b_tile` (row-major
// [n][D]): the S = Q K^T pattern (A and B both row-major over D).
template <int NJ>
__device__ __forceinline__ void mma_abt(float (&c)[NJ][4], const bf16* a_tile, int a_row0,
                                        const bf16* b_tile, int lane) {
  const int mi = lane / 8, rr = lane % 8;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, smem_u32(a_tile + (a_row0 + lane % 16) * ST + ks * 16 + (lane / 16) * 8));
#pragma unroll
    for (int j2 = 0; j2 < NJ / 2; ++j2) {
      uint32_t b[4];
      ldsm_x4(b, smem_u32(b_tile + (j2 * 16 + (mi / 2) * 8 + rr) * ST + ks * 16 + (mi % 2) * 8));
      mma_bf16(c[2 * j2], a, b[0], b[1]);
      mma_bf16(c[2 * j2 + 1], a, b[2], b[3]);
    }
  }
}

// acc[0..D/8) += P B, where P is the warp's 16 x (16 * NK) matrix held as
// fp32 C fragments p[2 * NK][4] (rounded to bf16 here) and B is rows
// [0, 16 * NK) of `b_tile` (row-major [k][D]): the O += P V pattern.
template <int NK>
__device__ __forceinline__ void mma_pb(float (&acc)[D / 8][4], const float (&p)[2 * NK][4],
                                       const bf16* b_tile, int lane) {
  const int mi = lane / 8, rr = lane % 8;
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int n2 = 0; n2 < D / 16; ++n2) {
      uint32_t b[4];
      ldsm_x4_trans(b, smem_u32(b_tile + (kk * 16 + (mi % 2) * 8 + rr) * ST + n2 * 16 +
                                (mi / 2) * 8));
      mma_bf16(acc[2 * n2], a, b[0], b[1]);
      mma_bf16(acc[2 * n2 + 1], a, b[2], b[3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

// keys a query tile of rows [i0, i0 + n) needs: up to kv_len, and in causal
// mode up to the tile's last position
__device__ __forceinline__ int key_end(const Dims& a, int kvl, int qoff, int i0, int n) {
  return a.causal ? min(kvl, qoff + i0 + n) : kvl;
}

__device__ __forceinline__ bool visible(const Dims& a, int key, int kvl, int pos) {
  return key < kvl && (!a.causal || key <= pos);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ out, float* __restrict__ lse, const int* __restrict__ q_offset,
    const int* __restrict__ kv_len, Dims a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BR * ST;
  bf16* Vs = Ks + BC * ST;
  const int i0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.HKV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_q = min(BR, a.Sq - i0);
  const long q_row = (long)a.H * D, kv_row = (long)a.HKV * D;
  const bf16* kb = k + (long)b * a.Sk * kv_row + (long)g * D;
  const bf16* vb = v + (long)b * a.Sk * kv_row + (long)g * D;
  const int qoff = q_offset[b];
  const int kvl = min(kv_len[b], a.Sk);
  const int k_end = key_end(a, kvl, qoff, i0, n_q);

  stage(Qs, q + ((long)b * a.Sq + i0) * q_row + (long)h * D, q_row, BR, n_q);
  const int r_a = warp * 16 + lane / 4, r_b = r_a + 8;  // this thread's two rows
  const int pos_a = qoff + i0 + r_a, pos_b = qoff + i0 + r_b;
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    ldsm_x4(qf[ks], smem_u32(Qs + (warp * 16 + lane % 16) * ST + ks * 16 + (lane / 16) * 8));
  }

  float m_a = -1e30f, m_b = -1e30f, l_a = 0.f, l_b = 0.f;
  float o[D / 8][4];
  zero(o);
  const int mi = lane / 8, rr = lane % 8;
  for (int k0 = 0; k0 < k_end; k0 += BC) {
    __syncthreads();  // the previous tile's ldmatrix reads are done
    stage(Ks, kb + (long)k0 * kv_row, kv_row, BC, a.Sk - k0);
    stage(Vs, vb + (long)k0 * kv_row, kv_row, BC, a.Sk - k0);
    __syncthreads();

    float s[BC / 8][4];
    zero(s);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
      for (int j2 = 0; j2 < BC / 16; ++j2) {
        uint32_t bk[4];
        ldsm_x4(bk, smem_u32(Ks + (j2 * 16 + (mi / 2) * 8 + rr) * ST + ks * 16 + (mi % 2) * 8));
        mma_bf16(s[2 * j2], qf[ks], bk[0], bk[1]);
        mma_bf16(s[2 * j2 + 1], qf[ks], bk[2], bk[3]);
      }
    }

    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < BC / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + j * 8 + 2 * (lane % 4) + e;
        s[j][e] = visible(a, key, kvl, pos_a) ? s[j][e] * a.scale : -INFINITY;
        s[j][2 + e] = visible(a, key, kvl, pos_b) ? s[j][2 + e] * a.scale : -INFINITY;
        mx_a = fmaxf(mx_a, s[j][e]);
        mx_b = fmaxf(mx_b, s[j][2 + e]);
      }
    }
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o2));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float corr_a = expf(m_a - mn_a), corr_b = expf(m_b - mn_b);
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < BC / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = s[j][e] == -INFINITY ? 0.f : expf(s[j][e] - mn_a);
        s[j][2 + e] = s[j][2 + e] == -INFINITY ? 0.f : expf(s[j][2 + e] - mn_b);
        sum_a += s[j][e];
        sum_b += s[j][2 + e];
      }
    }
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, o2);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, o2);
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= corr_a;
      o[n][1] *= corr_a;
      o[n][2] *= corr_b;
      o[n][3] *= corr_b;
    }
    mma_pb<BC / 16>(o, s, Vs, lane);
  }

  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  bf16* ob = out + ((long)b * a.Sq + i0) * q_row + (long)h * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int d = n * 8 + 2 * (lane % 4);
    if (r_a < n_q) {
      *reinterpret_cast<__nv_bfloat162*>(ob + (long)r_a * q_row + d) =
          __floats2bfloat162_rn(o[n][0] / den_a, o[n][1] / den_a);
    }
    if (r_b < n_q) {
      *reinterpret_cast<__nv_bfloat162*>(ob + (long)r_b * q_row + d) =
          __floats2bfloat162_rn(o[n][2] / den_b, o[n][3] / den_b);
    }
  }
  if (lane % 4 == 0) {
    float* lb = lse + ((long)b * a.H + h) * a.Sq + i0;
    if (r_a < n_q) lb[r_a] = l_a > 0.f ? m_a + logf(l_a) : -INFINITY;
    if (r_b < n_q) lb[r_b] = l_b > 0.f ? m_b + logf(l_b) : -INFINITY;
  }
}

// ---------------------------------------------------------------------------
// backward 1: delta = rowsum(dout * out), one warp per (token, head) row
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT) flash_bwd_delta_kernel(
    const bf16* __restrict__ out, const bf16* __restrict__ dout, float* __restrict__ delta,
    Dims a) {
  const long row = (long)blockIdx.x * (NT / 32) + threadIdx.x / 32;  // (b * Sq + i) * H + h
  const int lane = threadIdx.x % 32;
  if (row >= (long)a.B * a.Sq * a.H) return;
  const uint2 o4 = *reinterpret_cast<const uint2*>(out + row * D + lane * 4);
  const uint2 d4 = *reinterpret_cast<const uint2*>(dout + row * D + lane * 4);
  const float2 o01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&o4.x));
  const float2 o23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&o4.y));
  const float2 d01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&d4.x));
  const float2 d23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&d4.y));
  float sum = o01.x * d01.x + o01.y * d01.y + o23.x * d23.x + o23.y * d23.y;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0) {
    const int h = (int)(row % a.H);
    const long bi = row / a.H;
    const int i = (int)(bi % a.Sq), b = (int)(bi / a.Sq);
    delta[((long)b * a.H + h) * a.Sq + i] = sum;
  }
}

// ---------------------------------------------------------------------------
// backward 2: dK, dV per (64-key tile, KV head, sequence)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT) flash_bwd_dkdv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
    const int* __restrict__ q_offset, const int* __restrict__ kv_len, Dims a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BC * ST;
  bf16* Qs = Vs + BC * ST;
  bf16* dOs = Qs + BQ * ST;
  float* lse_s = reinterpret_cast<float*>(dOs + BQ * ST);
  float* delta_s = lse_s + BQ;
  const int k0 = blockIdx.x * BC, g = blockIdx.y, b = blockIdx.z;
  const int group = a.H / a.HKV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long q_row = (long)a.H * D, kv_row = (long)a.HKV * D;
  const long kv_off = ((long)b * a.Sk + k0) * kv_row + (long)g * D;
  const int n_k = min(BC, a.Sk - k0);
  const int qoff = q_offset[b];
  const int kvl = min(kv_len[b], a.Sk);
  const int key_a = k0 + warp * 16 + lane / 4, key_b = key_a + 8;  // this thread's two keys

  stage(Ks, k + kv_off, kv_row, BC, n_k);
  stage(Vs, v + kv_off, kv_row, BC, n_k);
  float dka[D / 8][4], dva[D / 8][4];
  zero(dka);
  zero(dva);
  // queries that see a key of this tile: all, or in causal mode those at
  // positions >= k0
  const int i_begin = a.causal ? max(0, k0 - qoff) / BQ * BQ : 0;
  const int i_end = k0 < kvl ? a.Sq : 0;  // a tile wholly past kv_len gets zeros
  for (int hq = 0; hq < group; ++hq) {
    const int h = g * group + hq;
    for (int i0 = i_begin; i0 < i_end; i0 += BQ) {
      const int n_q = min(BQ, a.Sq - i0);
      __syncthreads();  // the previous query tile's reads are done
      stage(Qs, q + ((long)b * a.Sq + i0) * q_row + (long)h * D, q_row, BQ, n_q);
      stage(dOs, dout + ((long)b * a.Sq + i0) * q_row + (long)h * D, q_row, BQ, n_q);
      for (int t = threadIdx.x; t < BQ; t += NT) {
        const long r = ((long)b * a.H + h) * a.Sq + i0 + t;
        lse_s[t] = t < n_q ? lse[r] : 0.f;
        delta_s[t] = t < n_q ? delta[r] : 0.f;
      }
      __syncthreads();

      float st[BQ / 8][4], dpt[BQ / 8][4];  // S^T and dP^T: 16 keys x BQ queries
      zero(st);
      zero(dpt);
      mma_abt<BQ / 8>(st, Ks, warp * 16, Qs, lane);
      mma_abt<BQ / 8>(dpt, Vs, warp * 16, dOs, lane);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = j * 8 + 2 * (lane % 4) + e;
          const int pos = qoff + i0 + qi;
          const bool live = qi < n_q;
          const float pa = live && visible(a, key_a, kvl, pos)
                               ? expf(st[j][e] * a.scale - lse_s[qi]) : 0.f;
          const float pb = live && visible(a, key_b, kvl, pos)
                               ? expf(st[j][2 + e] * a.scale - lse_s[qi]) : 0.f;
          st[j][e] = pa;
          st[j][2 + e] = pb;
          dpt[j][e] = pa * (dpt[j][e] - delta_s[qi]);       // dS^T
          dpt[j][2 + e] = pb * (dpt[j][2 + e] - delta_s[qi]);
        }
      }
      mma_pb<BQ / 16>(dva, st, dOs, lane);   // dV += P^T dout
      mma_pb<BQ / 16>(dka, dpt, Qs, lane);   // dK += dS^T Q
    }
  }

#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int d = n * 8 + 2 * (lane % 4);
    const long base = ((long)b * a.Sk) * kv_row + (long)g * D + d;
    if (key_a < a.Sk) {
      *reinterpret_cast<__nv_bfloat162*>(dk + base + (long)key_a * kv_row) =
          __floats2bfloat162_rn(dka[n][0] * a.scale, dka[n][1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + base + (long)key_a * kv_row) =
          __floats2bfloat162_rn(dva[n][0], dva[n][1]);
    }
    if (key_b < a.Sk) {
      *reinterpret_cast<__nv_bfloat162*>(dk + base + (long)key_b * kv_row) =
          __floats2bfloat162_rn(dka[n][2] * a.scale, dka[n][3] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + base + (long)key_b * kv_row) =
          __floats2bfloat162_rn(dva[n][2], dva[n][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward 3: dQ per (64-row query tile, query head, sequence)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, const int* __restrict__ q_offset,
    const int* __restrict__ kv_len, Dims a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + BR * ST;
  bf16* Ks = dOs + BR * ST;
  bf16* Vs = Ks + BC * ST;
  const int i0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.HKV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_q = min(BR, a.Sq - i0);
  const long q_row = (long)a.H * D, kv_row = (long)a.HKV * D;
  const long q_off = ((long)b * a.Sq + i0) * q_row + (long)h * D;
  const bf16* kb = k + (long)b * a.Sk * kv_row + (long)g * D;
  const bf16* vb = v + (long)b * a.Sk * kv_row + (long)g * D;
  const int qoff = q_offset[b];
  const int kvl = min(kv_len[b], a.Sk);
  const int k_end = key_end(a, kvl, qoff, i0, n_q);

  stage(Qs, q + q_off, q_row, BR, n_q);
  stage(dOs, dout + q_off, q_row, BR, n_q);
  const int r_a = warp * 16 + lane / 4, r_b = r_a + 8;
  const int pos_a = qoff + i0 + r_a, pos_b = qoff + i0 + r_b;
  const long lrow = ((long)b * a.H + h) * a.Sq + i0;
  const float lse_a = r_a < n_q ? lse[lrow + r_a] : 0.f;
  const float lse_b = r_b < n_q ? lse[lrow + r_b] : 0.f;
  const float del_a = r_a < n_q ? delta[lrow + r_a] : 0.f;
  const float del_b = r_b < n_q ? delta[lrow + r_b] : 0.f;
  float dqa[D / 8][4];
  zero(dqa);
  for (int k0 = 0; k0 < k_end; k0 += BC) {
    __syncthreads();
    stage(Ks, kb + (long)k0 * kv_row, kv_row, BC, a.Sk - k0);
    stage(Vs, vb + (long)k0 * kv_row, kv_row, BC, a.Sk - k0);
    __syncthreads();

    float s[BC / 8][4], dp[BC / 8][4];
    zero(s);
    zero(dp);
    mma_abt<BC / 8>(s, Qs, warp * 16, Ks, lane);   // S = Q K^T
    mma_abt<BC / 8>(dp, dOs, warp * 16, Vs, lane); // dP = dout V^T
#pragma unroll
    for (int j = 0; j < BC / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + j * 8 + 2 * (lane % 4) + e;
        const float pa = visible(a, key, kvl, pos_a) ? expf(s[j][e] * a.scale - lse_a) : 0.f;
        const float pb =
            visible(a, key, kvl, pos_b) ? expf(s[j][2 + e] * a.scale - lse_b) : 0.f;
        dp[j][e] = pa * (dp[j][e] - del_a);  // dS
        dp[j][2 + e] = pb * (dp[j][2 + e] - del_b);
      }
    }
    mma_pb<BC / 16>(dqa, dp, Ks, lane);  // dQ += dS K
  }

  bf16* qb = dq + q_off;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int d = n * 8 + 2 * (lane % 4);
    if (r_a < n_q) {
      *reinterpret_cast<__nv_bfloat162*>(qb + (long)r_a * q_row + d) =
          __floats2bfloat162_rn(dqa[n][0] * a.scale, dqa[n][1] * a.scale);
    }
    if (r_b < n_q) {
      *reinterpret_cast<__nv_bfloat162*>(qb + (long)r_b * q_row + d) =
          __floats2bfloat162_rn(dqa[n][2] * a.scale, dqa[n][3] * a.scale);
    }
  }
}

constexpr size_t kFwdSmem = (size_t)(BR + 2 * BC) * ST * 2;
constexpr size_t kDkdvSmem = (size_t)(2 * BC + 2 * BQ) * ST * 2 + 2 * BQ * 4;
constexpr size_t kDqSmem = (size_t)(2 * BR + 2 * BC) * ST * 2;

template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

Dims make_dims(int B, int Sq, int Sk, int H, int HKV, int causal, float scale) {
  return Dims{B, Sq, Sk, H, HKV, causal, scale};
}

bool bad_dims(int B, int Sq, int Sk, int H, int HKV, int d) {
  return d != D || B <= 0 || Sq <= 0 || Sk <= 0 || HKV <= 0 || H % HKV != 0 || B > 65535 ||
         H > 65535;
}

}  // namespace

extern "C" int flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                                        void* lse, const void* q_offset, const void* kv_len,
                                        int B, int Sq, int Sk, int H, int HKV, int d, int causal,
                                        float scale, void* stream) {
  if (bad_dims(B, Sq, Sk, H, HKV, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(flash_fwd_kernel, kFwdSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BR - 1) / BR, H, B);
  flash_fwd_kernel<<<grid, NT, kFwdSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<float*>(lse), static_cast<const int*>(q_offset),
      static_cast<const int*>(kv_len), make_dims(B, Sq, Sk, H, HKV, causal, scale));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* out, const void* dout, const void* lse,
                                        void* delta, void* dq, void* dk, void* dv,
                                        const void* q_offset, const void* kv_len, int B, int Sq,
                                        int Sk, int H, int HKV, int d, int causal, float scale,
                                        void* stream) {
  if (bad_dims(B, Sq, Sk, H, HKV, d)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims a = make_dims(B, Sq, Sk, H, HKV, causal, scale);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dop = static_cast<const bf16*>(dout);
  const float* lp = static_cast<const float*>(lse);
  float* dp = static_cast<float*>(delta);
  const int* qo = static_cast<const int*>(q_offset);
  const int* kl = static_cast<const int*>(kv_len);

  const long rows = (long)B * Sq * H;
  flash_bwd_delta_kernel<<<(unsigned)((rows + NT / 32 - 1) / (NT / 32)), NT, 0, st>>>(
      static_cast<const bf16*>(out), dop, dp, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = allow_smem(flash_bwd_dkdv_kernel, kDkdvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<<<dim3((Sk + BC - 1) / BC, HKV, B), NT, kDkdvSmem, st>>>(
      qp, kp, vp, dop, lp, dp, static_cast<bf16*>(dk), static_cast<bf16*>(dv), qo, kl, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = allow_smem(flash_bwd_dq_kernel, kDqSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<<<dim3((Sq + BR - 1) / BR, H, B), NT, kDqSmem, st>>>(
      qp, kp, vp, dop, lp, dp, static_cast<bf16*>(dq), qo, kl, a);
  return static_cast<int>(cudaGetLastError());
}
