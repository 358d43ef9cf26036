// Shared body of the two paged-attention kernels (paged_attention.cu,
// ragged_paged_attention.cu): one thread block computes causal GQA attention
// for one tile of query tokens of ONE sequence and ONE KV head over a range
// of that sequence's logical pages, walking them through its page-table row.
//
// Per block:
//   rows r = gq * bq + i   (gq < group query heads of KV head g, i < bq tokens)
//   for each staged key tile (KT keys of one page) in the block's page range
//   that the tile needs (key < kv_len and key <= the tile's largest query
//   position):
//     1. stage the [KT, D] K and V slice of head g in shared memory as bf16
//        (K rows padded by one 32-bit word so the per-key reads of step 2
//        hit distinct banks) through the cache's loader: KVBf16 copies
//        bf16 pages, KVInt8 dequantizes int8 pages on the way in as
//        bf16(float(q8) * scale[head][token]) — the cast point of the TPU
//        kernels (_paged_kernel_q8, _ragged_kernel_q8) — so every step
//        below is the same code for both cache types;
//     2. S[r, t] = scale * q_r . k_t, masked to -inf past kv_len, in the
//        causal future of the row's own position, or on a padding row;
//     3. online softmax per row in fp32 (m, l in shared memory), the
//        probabilities rounded to bf16 for the weighted sum exactly as the
//        reference casts its softmax weights to the value dtype;
//     4. acc[r, d] = acc * exp(m_old - m_new) + sum_t P[r, t] * v_t[d], with
//        the fp32 accumulator in registers (thread = output column d).
//   Then either the final bf16 output acc / max(l, 1e-30) (a row with no
//   valid key writes zeros), or — when the sequence's pages are split over
//   several blocks — the partial (m, l, acc) for combine_splits to merge.
//
// The trash page (physical page 0) is never trusted: only kv_len and the
// causal bound decide which keys count.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace fct {

// ---------------------------------------------------------------------------
// KV tile loaders: 8 consecutive head-dim values (one 16-byte bf16 chunk,
// columns [c*8, c*8+8)) of KV head g at token `off` of physical page `phys`,
// from one layer of the cache [P, page_size, Hkv*D].
// ---------------------------------------------------------------------------

struct KVBf16 {
  const __nv_bfloat16* k;  // the layer's pages
  const __nv_bfloat16* v;
  long hd;                 // Hkv * D
  int d;
  int ps;

  __device__ __forceinline__ uint4 load(const __nv_bfloat16* p, long phys, int off, int g,
                                        int c) const {
    return *reinterpret_cast<const uint4*>(p + (phys * ps + off) * hd + (long)g * d + c * 8);
  }
  __device__ __forceinline__ uint4 k8(long phys, int off, int g, int c) const {
    return load(k, phys, off, g, c);
  }
  __device__ __forceinline__ uint4 v8(long phys, int off, int g, int c) const {
    return load(v, phys, off, g, c);
  }
};

// int8 pages with per-token-per-head fp32 scales [P, spad, page_size]
// (spad = Hkv padded to 8 rows, the cache's scale_rows layout)
struct KVInt8 {
  const int8_t* k;
  const int8_t* v;
  const float* ks;
  const float* vs;
  long hd;
  int d;
  int ps;
  int spad;

  __device__ __forceinline__ uint4 load(const int8_t* p, const float* s, long phys, int off,
                                        int g, int c) const {
    const uint2 raw =
        *reinterpret_cast<const uint2*>(p + (phys * ps + off) * hd + (long)g * d + c * 8);
    const float sc = s[(phys * spad + g) * ps + off];
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
    uint4 out;
    out.x = pack_bf16((float)b[0] * sc, (float)b[1] * sc);
    out.y = pack_bf16((float)b[2] * sc, (float)b[3] * sc);
    out.z = pack_bf16((float)b[4] * sc, (float)b[5] * sc);
    out.w = pack_bf16((float)b[6] * sc, (float)b[7] * sc);
    return out;
  }
  __device__ __forceinline__ uint4 k8(long phys, int off, int g, int c) const {
    return load(k, ks, phys, off, g, c);
  }
  __device__ __forceinline__ uint4 v8(long phys, int off, int g, int c) const {
    return load(v, vs, phys, off, g, c);
  }
};

constexpr int kThreads = 128;
constexpr int kMaxRows = 64;             // query rows per block (group * tile tokens)
constexpr int kPosBytes = kMaxRows * 4;  // tile token positions, head of smem

// dynamic shared memory a block needs: key tile kt, head dim D, R rows
inline size_t smem_bytes(int D, int kt, int R) {
  return kPosBytes
         + (size_t)kt * (D / 2 + 1) * 4  // K tile, padded bf16x2 words
         + (size_t)kt * D * 2            // V tile
         + (size_t)R * D * 4             // Q rows (fp32)
         + (size_t)R * kt * 4            // scores / probabilities
         + (size_t)R * 3 * 4;            // m, l, rescale factor
}

// Where a block's result goes: the final bf16 output, or fp32 partials of
// one split (acc [tok, H, D], ml [tok, H, 2]) that combine_splits merges.
struct TileOut {
  __nv_bfloat16* out;  // final output at the tile's token 0, or nullptr
  float* part_acc;     // partials at the tile's token 0 (when out == nullptr)
  float* part_ml;
  long tok_stride;     // elements between consecutive tokens (H * D)
  int H;
};

template <int D, int MAXROWS, class KV>
__device__ __forceinline__ void attend_tile(
    const __nv_bfloat16* __restrict__ q_tile, long q_tok_stride, TileOut dst,
    const int* s_pos, int n_tok, int bq, int group, int g, const KV& kv,
    const int* __restrict__ pt_row, int kv_len, int ps, int kt, int p_begin, int p_end,
    float scale, unsigned char* smem) {
  constexpr int RG = kThreads / D;         // row groups sharing one column
  constexpr int MAXR = MAXROWS / RG;       // accumulator rows per thread
  constexpr int KW = D / 2 + 1;            // padded K row stride in words
  constexpr int V8 = D / 8;                // 16-byte chunks per row
  constexpr int RCH = MAXROWS < 16 ? MAXROWS : 16;  // score rows per pass
  const int tid = threadIdx.x;
  const int R = group * bq;

  uint32_t* Ks = reinterpret_cast<uint32_t*>(smem);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + (size_t)kt * KW * 4);
  float* Qs = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(Vs) + (size_t)kt * D * 2);
  float* Ss = Qs + R * D;
  float* Ms = Ss + R * kt;
  float* Ls = Ms + R;
  float* As = Ls + R;

  for (int idx = tid; idx < R * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int gq = r / bq, i = r % bq;
    float val = 0.f;
    if (i < n_tok) {
      val = __bfloat162float(q_tile[(long)i * q_tok_stride + (long)(g * group + gq) * D + d]);
    }
    Qs[idx] = val;
  }
  for (int r = tid; r < R; r += kThreads) {
    Ms[r] = -1e30f;
    Ls[r] = 0.f;
    As[r] = 1.f;
  }
  int q_max = -1;
  for (int i = 0; i < n_tok; ++i) q_max = max(q_max, s_pos[i]);
  // keys this block attends: its page range, cut at kv_len and the tile's
  // last query position (later keys are masked for every row)
  const int k_begin = p_begin * ps;
  const int k_end = min(min(p_end * ps, kv_len), q_max + 1);

  const int dcol = tid % D;
  const int rg = tid / D;
  const int key_groups = kThreads / kt;  // threads sharing one key in step 2
  float acc[MAXR];
#pragma unroll
  for (int j = 0; j < MAXR; ++j) acc[j] = 0.f;
  __syncthreads();

  for (int k0 = k_begin; k0 < k_end; k0 += kt) {
    const long phys = pt_row[k0 / ps];
    const int off0 = k0 % ps;  // kt divides ps: one page per tile
    for (int idx = tid; idx < kt * V8; idx += kThreads) {
      const int t = idx / V8, c = idx % V8;
      const uint4 kc = kv.k8(phys, off0 + t, g, c);
      uint32_t* kd = Ks + t * KW + c * 4;
      kd[0] = kc.x;
      kd[1] = kc.y;
      kd[2] = kc.z;
      kd[3] = kc.w;
      *reinterpret_cast<uint4*>(Vs + t * D + c * 8) = kv.v8(phys, off0 + t, g, c);
    }
    __syncthreads();

    // scores: thread (key t, group kg) takes row chunks kg, kg + key_groups, ...
    {
      const int t = tid % kt;
      const int kv_pos = k0 + t;
      const uint32_t* krow = Ks + t * KW;
      for (int r0 = (tid / kt) * RCH; r0 < R; r0 += key_groups * RCH) {
        float s[RCH];
#pragma unroll
        for (int j = 0; j < RCH; ++j) s[j] = 0.f;
        for (int d = 0; d < D; d += 4) {
          const float2 k01 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(krow + d / 2));
          const float2 k23 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(krow + d / 2 + 1));
#pragma unroll
          for (int j = 0; j < RCH; ++j) {
            if (r0 + j < R) {
              const float4 qv = *reinterpret_cast<const float4*>(Qs + (r0 + j) * D + d);
              s[j] += qv.x * k01.x + qv.y * k01.y + qv.z * k23.x + qv.w * k23.y;
            }
          }
        }
#pragma unroll
        for (int j = 0; j < RCH; ++j) {
          const int r = r0 + j;
          if (r < R) {
            const int i = r % bq;
            const bool ok = (i < n_tok) && (kv_pos < kv_len) && (kv_pos <= s_pos[i]);
            Ss[r * kt + t] = ok ? s[j] * scale : -INFINITY;
          }
        }
      }
    }
    __syncthreads();

    // online softmax, one warp per row
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < R; r += kThreads / 32) {
      const float m_prev = Ms[r];
      float mx = -INFINITY;
      for (int t = lane; t < kt; t += 32) mx = fmaxf(mx, Ss[r * kt + t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < kt; t += 32) {
        const float sv = Ss[r * kt + t];
        const float pv = (sv == -INFINITY) ? 0.f : expf(sv - m_new);
        sum += pv;
        Ss[r * kt + t] = __bfloat162float(__float2bfloat16(pv));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        Ms[r] = m_new;
        Ls[r] = Ls[r] * corr + sum;
        As[r] = corr;
      }
    }
    __syncthreads();

    // weighted sum of V: thread owns column dcol for rows j*RG + rg
#pragma unroll
    for (int j = 0; j < MAXR; ++j) {
      const int r = j * RG + rg;
      if (r < R) acc[j] *= As[r];
    }
    for (int t = 0; t < kt; t += 4) {
      const float v0 = __bfloat162float(Vs[(t + 0) * D + dcol]);
      const float v1 = __bfloat162float(Vs[(t + 1) * D + dcol]);
      const float v2 = __bfloat162float(Vs[(t + 2) * D + dcol]);
      const float v3 = __bfloat162float(Vs[(t + 3) * D + dcol]);
#pragma unroll
      for (int j = 0; j < MAXR; ++j) {
        const int r = j * RG + rg;
        if (r < R) {
          const float4 pv = *reinterpret_cast<const float4*>(Ss + r * kt + t);
          acc[j] += pv.x * v0 + pv.y * v1 + pv.z * v2 + pv.w * v3;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < MAXR; ++j) {
    const int r = j * RG + rg;
    if (r < R) {
      const int gq = r / bq, i = r % bq;
      if (i < n_tok) {
        const long h = (long)g * group + gq;
        const long o = (long)i * dst.tok_stride + h * D + dcol;
        if (dst.out != nullptr) {
          dst.out[o] = __float2bfloat16(acc[j] / fmaxf(Ls[r], 1e-30f));
        } else {
          dst.part_acc[o] = acc[j];
          if (dcol == 0) {
            const long ml = ((long)i * dst.H + h) * 2;
            dst.part_ml[ml] = Ms[r];
            dst.part_ml[ml + 1] = Ls[r];
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core variant for full 64-row tiles at head_dim 128 (prefill chunks
// and ragged prefill rows): the same causal online softmax, with S = Q K^T
// and O += P V as mma.sync m16n8k16 bf16 products accumulated in fp32.
// Each of the 4 warps owns 16 query rows; Q stays in registers as A
// fragments, K and V tiles of 64 keys are staged in padded shared memory
// (row stride 136 elements, so ldmatrix rows hit distinct banks) and read
// with ldmatrix (V transposed). P is rounded to bf16 for the PV product, as
// the reference casts its softmax weights to the value dtype.
// ---------------------------------------------------------------------------

constexpr int kTcRows = 64;    // 4 warps x 16 rows
constexpr int kTcKeys = 64;    // keys per staged tile (page_size % 64 == 0)
constexpr int kTcStride = 136; // bf16 elements per shared-memory row (128 + 8)

inline size_t smem_bytes_tc() {
  return kPosBytes + 3 * (size_t)kTcRows * kTcStride * 2;
}

// R = group * bq must be 64 and D 128; writes the final output (no splits).
template <class KV>
__device__ __forceinline__ void attend_tile_tc(
    const __nv_bfloat16* __restrict__ q_tile, long q_tok_stride, TileOut dst,
    const int* s_pos, int n_tok, int bq, int group, int g, const KV& kv,
    const int* __restrict__ pt_row, int kv_len, int ps, int p_begin, int p_end, float scale,
    unsigned char* smem) {
  constexpr int D = 128, ST = kTcStride, KT = kTcKeys, C8 = D / 8;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + kTcRows * ST;
  __nv_bfloat16* Vs = Ks + KT * ST;

  for (int idx = tid; idx < kTcRows * C8; idx += kThreads) {
    const int r = idx / C8, c = idx % C8;
    const int gq = r / bq, i = r % bq;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (i < n_tok) {
      v = *reinterpret_cast<const uint4*>(q_tile + (long)i * q_tok_stride +
                                          (long)(g * group + gq) * D + c * 8);
    }
    *reinterpret_cast<uint4*>(Qs + r * ST + c * 8) = v;
  }
  int q_max = -1;
  for (int i = 0; i < n_tok; ++i) q_max = max(q_max, s_pos[i]);
  const int k_begin = p_begin * ps;
  const int k_end = min(min(p_end * ps, kv_len), q_max + 1);

  // this thread's two rows of its warp's 16 (C-fragment rows lane/4, +8)
  const int r_a = warp * 16 + lane / 4, r_b = r_a + 8;
  const int i_a = r_a % bq, i_b = r_b % bq;
  const bool v_a = i_a < n_tok, v_b = i_b < n_tok;
  const int pos_a = v_a ? s_pos[i_a] : -1, pos_b = v_b ? s_pos[i_b] : -1;
  __syncthreads();

  uint32_t qf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    ldsm_x4(qf[ks], smem_u32(Qs + (warp * 16 + lane % 16) * ST + ks * 16 + (lane / 16) * 8));
  }

  float m_a = -1e30f, m_b = -1e30f, l_a = 0.f, l_b = 0.f;
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  const int mi = lane / 8, rr = lane % 8;
  for (int k0 = k_begin; k0 < k_end; k0 += KT) {
    __syncthreads();  // the previous tile's ldmatrix reads are done
    const long phys = pt_row[k0 / ps];
    const int off0 = k0 % ps;
    for (int idx = tid; idx < KT * C8; idx += kThreads) {
      const int t = idx / C8, c = idx % C8;
      *reinterpret_cast<uint4*>(Ks + t * ST + c * 8) = kv.k8(phys, off0 + t, g, c);
      *reinterpret_cast<uint4*>(Vs + t * ST + c * 8) = kv.v8(phys, off0 + t, g, c);
    }
    __syncthreads();

    float s[KT / 8][4];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int j2 = 0; j2 < KT / 16; ++j2) {
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t b[4];
        ldsm_x4(b, smem_u32(Ks + (j2 * 16 + (mi / 2) * 8 + rr) * ST + ks * 16 + (mi % 2) * 8));
        mma_bf16(s[2 * j2], qf[ks], b[0], b[1]);
        mma_bf16(s[2 * j2 + 1], qf[ks], b[2], b[3]);
      }
    }

    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + j * 8 + 2 * (lane % 4) + e;
        const bool ok = key < kv_len;
        s[j][e] = (ok && key <= pos_a) ? s[j][e] * scale : -INFINITY;
        s[j][2 + e] = (ok && key <= pos_b) ? s[j][2 + e] * scale : -INFINITY;
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
    for (int j = 0; j < KT / 8; ++j) {
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
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      const uint32_t pf[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t b[4];
        ldsm_x4_trans(b, smem_u32(Vs + (kk * 16 + (mi % 2) * 8 + rr) * ST + n2 * 16 +
                                  (mi / 2) * 8));
        mma_bf16(o[2 * n2], pf, b[0], b[1]);
        mma_bf16(o[2 * n2 + 1], pf, b[2], b[3]);
      }
    }
  }

  const long h_a = (long)g * group + r_a / bq, h_b = (long)g * group + r_b / bq;
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int d = n * 8 + 2 * (lane % 4);
    if (v_a) {
      *reinterpret_cast<__nv_bfloat162*>(dst.out + (long)i_a * dst.tok_stride + h_a * D + d) =
          __floats2bfloat162_rn(o[n][0] / den_a, o[n][1] / den_a);
    }
    if (v_b) {
      *reinterpret_cast<__nv_bfloat162*>(dst.out + (long)i_b * dst.tok_stride + h_b * D + d) =
          __floats2bfloat162_rn(o[n][2] / den_b, o[n][3] / den_b);
    }
  }
}

// Merge S split partials per (token, head): out = sum_s acc_s e^(m_s - m*) /
// sum_s l_s e^(m_s - m*), m* = max_s m_s. One block per token, one thread
// per (head, column) element, looping.
__global__ void combine_splits(const float* __restrict__ part_acc,
                               const float* __restrict__ part_ml,
                               __nv_bfloat16* __restrict__ out, int n_tok, int H, int D,
                               int S) {
  const int tok = blockIdx.x;
  const long split_acc = (long)n_tok * H * D;
  const long split_ml = (long)n_tok * H * 2;
  for (int e = threadIdx.x; e < H * D; e += blockDim.x) {
    const int h = e / D;
    const long ml = ((long)tok * H + h) * 2;
    float m_star = -INFINITY;
    for (int s = 0; s < S; ++s) m_star = fmaxf(m_star, part_ml[s * split_ml + ml]);
    float l = 0.f, a = 0.f;
    for (int s = 0; s < S; ++s) {
      const float w = expf(part_ml[s * split_ml + ml] - m_star);
      l += part_ml[s * split_ml + ml + 1] * w;
      a += part_acc[s * split_acc + (long)tok * H * D + e] * w;
    }
    out[(long)tok * H * D + e] = __float2bfloat16(a / fmaxf(l, 1e-30f));
  }
}

}  // namespace fct
