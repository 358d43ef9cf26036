// K7's backward for Hopper: dQ, dK and dV of contiguous causal attention.
//
// Replaces the TPU kernel finchat_tpu/ops/flash_attention.py flash_attention
// (:160, kernel _flash_kernel :84) in its gradient. The JAX package has no
// backward for that kernel (its train step differentiates mha_reference), so
// this computes what jax.grad of mha_reference computes, for the calls the
// Hopper forward takes (ops/flash_attention.flash_bwd_kernel_for: causal,
// head_dim 128, query tiles of 64 rows = group * tile tokens, 16-byte
// aligned), in the flash-attention-2 form of the plain version
// flash_attention_bwd_ref: P = exp(S scale - lse) from the forward's
// log-sum-exp, delta = rowsum(dO * O), dS = P (dP - delta), dV = P^T dO,
// dK = scale dS^T Q, dQ = scale dS K, dK and dV summed over each KV head's
// group of query heads; P is rounded to bf16 before P^T dO (the forward
// rounds it before P V) and dS before its two products (tensor-core inputs);
// the gradients are bf16. Rows without a valid key (kv_len 0) get no
// gradient. The older backward (flash_attention.cu: synchronous staging,
// mma.sync, 32-row query tiles walked one head at a time) keeps every other
// call.
//
// What bounds it on the H100: tensor-core operations. At the training shape
// (Llama-3-8B, B = 1, S = 2048, 32 heads over 8, causal: 2,098,176 (query,
// key) pairs a head) the five products the gradient needs are 10 * pairs *
// H * D = 85.9 GFLOP (0.0869 ms at 989 TFLOP/s) on 50 MB in and out (0.015
// ms at 3.35 TB/s). This kernel recomputes S and dP in its dQ pass: seven
// products, 120 GFLOP.
//
// Design: three launches in order on the caller's stream, no atomics (two
// launches give the same bits).
// 1. A pre-pass, one warp a row: delta = rowsum(dO * O) in fp32 and the
//    row's log-sum-exp in base 2 (lse * log2 e), laid out per 64-row query
//    tile in the tile's row order ([B, Hkv, query tiles, 2, 64] fp32), so a
//    tile's two vectors are one 512-byte copy. A row past Sq, or whose lse
//    is -inf (no valid key), gets +inf and 0: its P is exp2(s - inf) = 0.
// 2. dK/dV. A block takes the 64-key tiles j and n - 1 - j of one KV head
//    and sequence: under the causal mask tile j sees S - 64 j queries, so
//    every pair sees as many and the training shape's 16 pairs x 8 KV heads
//    are 128 blocks of equal work, one wave on 132 SMs. Their K and V come
//    once by TMA and stay in shared memory. The query side of each key tile
//    streams in turn through a ring of kStages stages: a query tile's Q and
//    dO (64 rows each) by TMA and its lse and delta by a bulk copy. A query
//    tile packs the group's heads as the forward's does (tile tokens x
//    group), token-major here (row r: token r >> log2(group), head r %
//    group), which is what one 4D TMA box of [B, Sq, H, D] gives; the GQA
//    sum over heads happens in the accumulator. The two consumer
//    warpgroups take the stream's tiles in turn (even and odd), each
//    holding its own dK and dV sums for the key tile, so both stay busy
//    over either walk whatever its length; each fetches its own tiles into
//    its own two stages, the next but one as soon as one is read (a
//    warpgroup barrier, then its first thread); at the end of a walk the two
//    sums are added in a fixed order through the walk's K/V tiles (read no
//    more): consumer 1's dV into consumer 0's, consumer 0's dK into
//    consumer 1's, and each stores one of them. A consumer runs, a query
//    tile, S^T = K Q^T as m64n64k16 (both operands in shared memory, the
//    query tile read K-major) and P^T = exp2(S^T scale log2 e - lse2); dV
//    += P^T dO as m64n128k16 (P^T from registers, dO read MN-major through
//    the transpose bit, as the forward reads V); dP^T = V dO^T, dS^T = P^T
//    (dP^T - delta) and dK += dS^T Q likewise.
// 3. dQ. A block takes `tiles` (1 or 2, ops/paged_attention
//    .query_tiles_per_block) 64-row query tiles of one KV head and sequence,
//    heaviest first, one a consumer warpgroup, whose Q and dO come once by
//    TMA; the producer streams 64-key K/V tiles through the ring (keys cut
//    at kv_len and at the block's last position). S = Q K^T and dP = dO V^T
//    as m64n64k16 (K and V read K-major), dS in registers, dQ += dS K as
//    m64n128k16 with K read MN-major: no layout beyond the forward's. The
//    forward's 128-key tiles would not fit the registers here (S, dP and dQ
//    alone take 192 a thread).
// Registers: a dK/dV consumer holds dK and dV (64 + 64 fp32 a thread) for
// the whole walk, and ptxas gives each operand of the products in flight a
// block of its own above the ~24 it keeps for scalars. A producer
// warpgroup giving its registers to two consumers with setmaxnreg (24 and
// 240, (24 + 2 * 240) * 128 <= 65,536) did not serve here: ptxas kept the
// consumer code under ~170-196 registers whatever the count, spilled, and
// serialized every wgmma (C7512); nor did a producer warp beside the two
// consumers (288 threads: ptxas counts whole warpgroups and kept 168). So
// the dK/dV block is the two consumer warpgroups alone, 256 threads and up
// to 255 registers a thread, each consumer's first thread fetching its own
// ring stages (below). The step's products run one at a time — S^T; dV +=
// P^T dO; dP^T; dK += dS^T Q — so at most P^T (fp32, dS needs it
// unrounded) and dP^T sit beside the sums. The dQ block keeps the
// forward's split (40 and 232): its S, dP and dQ (32 + 32 + 64) fit.
// Edges. K, V, Q and dO are read as 4D tensors [B, S, heads, 128], so a box
// never runs into the next sequence: TMA fills rows past Sk or Sq with
// zeros. A key at or past kv_len (the sequence's own rows up to Sk, which
// may hold anything) gets P = 0 and dS = 0 by selection, never by a
// product; the dQ pass also zeroes K's rows at or past kv_len in the last
// tile before dS K, so no stale value reaches a sum (0 x NaN is NaN). Masks
// run only in tiles that cross kv_len or the diagonal. No dK/dV row at or
// past Sk and no dQ row at or past Sq is stored. Every mbarrier wait traps
// after ~2^34 cycles instead of hanging.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"
#include "sm90_pipeline.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int D = 128;                   // head_dim
constexpr int kRows = 64;                // rows of a query tile, keys of a key tile
constexpr int kPanel = kRows * 128;      // a 64-row x 64-column bf16 panel: one TMA box
constexpr int kTile = 2 * kPanel;        // a 64-row x 128-d tile: two panels
constexpr int kStages = 4;               // ring stages
constexpr int kWarpgroup = 128;          // threads
// dQ: a producer and two consumer warpgroups, registers split by setmaxnreg
// (40 and 232, as the forward's); dK/dV: two consumer warpgroups, each
// fetching its own tiles, 255 registers a thread (the note says why)
constexpr int kThreads = 3 * kWarpgroup;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(kProducerRegs + 2 * kConsumerRegs <= 3 * 168, "the launch's registers");
constexpr int kThreadsKV = 2 * kWarpgroup;
constexpr int kLd = 2 * kRows;           // a query tile's base-2 lse and delta (floats)

// dynamic shared memory from a 1024-byte aligned base (the swizzle atoms):
// two fixed pairs of tiles (dK/dV: K and V of each walk; dQ: Q and dO of
// each consumer), the ring (two tiles a stage: Q and dO, or K and V), each
// stage's lse and delta (dK/dV), the barriers
constexpr int FIX_OFF = 0;
constexpr int RING_OFF = FIX_OFF + 4 * kTile;
constexpr int LD_OFF = RING_OFF + kStages * 2 * kTile;
constexpr int FULL_OFF = LD_OFF + kStages * kLd * 4;
constexpr int EMPTY_OFF = FULL_OFF + kStages * 8;
constexpr int FIX_BAR_OFF = EMPTY_OFF + kStages * 8;
constexpr int kSmem = FIX_BAR_OFF + 8 + 1024;  // + alignment slack
static_assert(RING_OFF % 1024 == 0 && LD_OFF % 1024 == 0 && FULL_OFF % 8 == 0, "layout");
static_assert(kSmem <= 232448, "shared memory");

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* smem) {
  return smem + (((fct::smem_u32(smem) + 1023u) & ~1023u) - fct::smem_u32(smem));
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// the MN-major descriptor of the 16-row slice at `addr` of a 64-row x 128
// tile (1024-byte aligned): 8-row groups 1024 bytes apart (stride offset),
// the second 64-column panel kPanel bytes on (leading offset), 128-byte
// swizzle
__device__ __forceinline__ uint64_t mn_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(kPanel >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// keeps the compiler from moving definitions of fragments past the fence,
// into products in flight
__device__ __forceinline__ void fence_frags(uint32_t (&f)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(f[kk][i])::"memory");
  }
}

// desc += STEP (16-byte units) where the compiler can neither hoist nor
// precompute it, so a chain of products keeps one descriptor an operand
// live, not one a product: the dK/dV consumer's sums leave no room for more
template <int STEP>
__device__ __forceinline__ void advance(uint64_t& desc) {
  asm volatile("add.s64 %0, %0, %1;\n" : "+l"(desc) : "n"(STEP));
}

// d [64 x 64] = A B^T over the 128 d of the 64-row tiles at a and b, both
// two K-major panels (issued, not waited on)
__device__ __forceinline__ void tile_abt(float (&d)[32], uint32_t a, uint32_t b) {
  uint64_t da = fct::sw128_desc(a), db = fct::sw128_desc(b);
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    if (ks == 0) {
      fct::wgmma_m64n64k16_ss_first(d, da, db);
    } else {
      fct::wgmma_m64n64k16_ss(d, da, db);
    }
    // a 16-wide d slice starts 32 bytes further into its panel's rows; the
    // fifth starts the second panel
    if (ks == 3) {
      advance<kPanel / 16 - 6>(da);
      advance<kPanel / 16 - 6>(db);
    } else if (ks < D / 16 - 1) {
      advance<2>(da);
      advance<2>(db);
    }
  }
}

// acc [64 x 128] += F [64 x 64] T: F in wgmma's A fragments, T the 64-row x
// 128 tile at t read MN-major, 16 rows a product (issued, not waited on)
__device__ __forceinline__ void tile_ft(float (&acc)[64], const uint32_t (&f)[4][4], uint32_t t) {
  uint64_t dt = mn_desc(t);
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk) {
    fct::wgmma_m64n128k16_rs<1>(acc, f[kk], dt, 1);
    if (kk < kRows / 16 - 1) advance<16 * 128 / 16>(dt);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// A 64 x 64 accumulator x holds x[4j + e] at row a (e < 2) or b, column
// 8j + 2(lane % 4) + e % 2; as wgmma's A fragments (16 columns a k-step kk =
// j / 2), columns 8j.. of rows a and b are f[kk][2 * (j % 2)] and the next
// register. The functions below pack each bf16 pair as soon as it is formed.

// P^T of a key tile against a query tile, in place of S^T (st, fp32: dS
// needs it unrounded) and as A fragments pf: rows are keys (this thread's
// key_a and key_a + 8), columns the tile's query rows c, at position pos0 +
// (c >> gshift), with base-2 lse ld[c]. MASKED where the tile crosses kv_len
// or the diagonal: keys at or past kv_len or past a row's position get P = 0
// by selection.
template <bool MASKED>
__device__ __forceinline__ void probs_t(float (&st)[32], uint32_t (&pf)[4][4],
                                        const float* __restrict__ ld, int key_a, int kvl,
                                        int pos0, int gshift, float c2, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * (lane % 4);
    const float2 l2 = *reinterpret_cast<const float2*>(ld + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // column c + e % 2, key a or b (e / 2)
      float& x = st[4 * j + e];
      x = fct::exp2_approx(fmaf(x, c2, (e & 1) ? -l2.y : -l2.x));
      if (MASKED) {
        const int key = key_a + 8 * (e >> 1);
        x = key < kvl && key <= pos0 + ((c + (e & 1)) >> gshift) ? x : 0.f;
      }
    }
    pf[j / 2][2 * (j % 2)] = fct::pack_bf16(st[4 * j], st[4 * j + 1]);
    pf[j / 2][2 * (j % 2) + 1] = fct::pack_bf16(st[4 * j + 2], st[4 * j + 3]);
  }
}

// dS^T = P^T (dP^T - delta) as A fragments sf, from P^T (pt, fp32) and dP^T
// (dpt), delta ld[64 + c] a column. MASKED: where P is 0 (masked keys, whose
// dP^T may be anything) dS is 0 by selection.
template <bool MASKED>
__device__ __forceinline__ void dscores_t(const float (&pt)[32], const float (&dpt)[32],
                                          uint32_t (&sf)[4][4], const float* __restrict__ ld,
                                          int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 dl = *reinterpret_cast<const float2*>(ld + kRows + 8 * j + 2 * (lane % 4));
    float ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = pt[4 * j + e];
      ds[e] = p * (dpt[4 * j + e] - ((e & 1) ? dl.y : dl.x));
      if (MASKED) ds[e] = p != 0.f ? ds[e] : 0.f;
    }
    sf[j / 2][2 * (j % 2)] = fct::pack_bf16(ds[0], ds[1]);
    sf[j / 2][2 * (j % 2) + 1] = fct::pack_bf16(ds[2], ds[3]);
  }
}

// dS of a query tile against a key tile at k0, as A fragments sf, from S
// (s) and dP (dp): rows are this thread's rows a and b (base-2 lse l2, delta
// dl, position pos), columns keys. MASKED as probs_t: keys at or past kv_len
// or past a row's position get dS = 0 by selection.
template <bool MASKED>
__device__ __forceinline__ void grads_q(const float (&s)[32], const float (&dp)[32],
                                        uint32_t (&sf)[4][4], const float (&l2)[2],
                                        const float (&dl)[2], const int (&pos)[2], int k0,
                                        int kvl, float c2, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // key k0 + 8j + 2(lane % 4) + e % 2, row a or b (e / 2)
      const int r = e >> 1;
      const float p = fct::exp2_approx(fmaf(s[4 * j + e], c2, -l2[r]));
      ds[e] = p * (dp[4 * j + e] - dl[r]);
      if (MASKED) {
        const int key = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
        ds[e] = key < kvl && key <= pos[r] ? ds[e] : 0.f;
      }
    }
    const int kk = j / 2, h = 2 * (j % 2);
    sf[kk][h] = fct::pack_bf16(ds[0], ds[1]);
    sf[kk][h + 1] = fct::pack_bf16(ds[2], ds[3]);
  }
}

// rows [live, 64) of the K tile at `tile` zeroed (this warpgroup writes them
// all; another consumer reading the tile writes the same zeros), visible to
// wgmma once every thread of warpgroup w passed the named barrier 2 + w
__device__ __forceinline__ void zero_k_tail(unsigned char* tile, int live, int w, int wtid) {
  for (int idx = wtid; idx < (kRows - live) * 16; idx += kWarpgroup) {
    const int r = live + idx / 16, c = idx % 16;
    *reinterpret_cast<uint4*>(tile + (c / 8) * kPanel + r * 128 + (((c % 8) ^ (r & 7)) << 4)) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  fct::fence_proxy_async();
  named_sync(2 + w, kWarpgroup);
}

// this thread's two rows (r_a, r_a + 8) of a 64 x 128 accumulator, times
// `mul`, in bf16 at dst + row * stride, rows below n only
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, long stride,
                                           const float (&acc)[64], float mul, int n, int r_a,
                                           int lane) {
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int d = 8 * i + 2 * (lane % 4);
    if (r_a < n) {
      *reinterpret_cast<__nv_bfloat162*>(dst + (long)r_a * stride + d) =
          __floats2bfloat162_rn(acc[4 * i] * mul, acc[4 * i + 1] * mul);
    }
    if (r_a + 8 < n) {
      *reinterpret_cast<__nv_bfloat162*>(dst + (long)(r_a + 8) * stride + d) =
          __floats2bfloat162_rn(acc[4 * i + 2] * mul, acc[4 * i + 3] * mul);
    }
  }
}

// walk w of the dK/dV block of `pair`: the key tile at k0 (tile pair, then
// tile n_kt - 1 - pair) against query tiles [walk_begin, n_qt), those holding
// a position at or past k0 (none if its keys are all at or past kv_len)
__device__ __forceinline__ int walk_k0(int w, int pair, int n_kt) {
  return (w == 0 ? pair : n_kt - 1 - pair) * kRows;
}
__device__ __forceinline__ int walk_begin(int k0, int kvl, int qoff, int BQ, int n_qt) {
  return k0 >= kvl ? n_qt : max(0, k0 - qoff) / BQ;
}

// ---------------------------------------------------------------------------
// 1. the pre-pass: one warp a row of ld [B, Hkv, n_qt, 2, 64]
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(128) flash_bwd_prep_sm90_kernel(
    const bf16* __restrict__ out, const bf16* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ ld, int B, int Sq, int H, int HKV, int BQ, int gshift, int n_qt) {
  const long row = (long)blockIdx.x * 4 + threadIdx.x / 32;  // tile * 64 + r
  const int lane = threadIdx.x % 32;
  if (row >= (long)B * HKV * n_qt * kRows) return;
  const int r = (int)(row % kRows);
  const long tile = row / kRows;  // (b * HKV + g) * n_qt + t
  const int t = (int)(tile % n_qt), g = (int)(tile / n_qt % HKV), b = (int)(tile / n_qt / HKV);
  const int tok = t * BQ + (r >> gshift), h = (g << gshift) + (r & ((1 << gshift) - 1));
  float delta = 0.f, l2 = INFINITY;
  if (tok < Sq) {  // the whole warp's row
    const long off = (((long)b * Sq + tok) * H + h) * D + lane * 4;
    const uint2 o4 = *reinterpret_cast<const uint2*>(out + off);
    const uint2 d4 = *reinterpret_cast<const uint2*>(dout + off);
    const float2 o01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&o4.x));
    const float2 o23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&o4.y));
    const float2 d01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&d4.x));
    const float2 d23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&d4.y));
    delta = o01.x * d01.x + o01.y * d01.y + o23.x * d23.x + o23.y * d23.y;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) delta += __shfl_xor_sync(0xffffffffu, delta, o);
    const float l = lse[((long)b * H + h) * Sq + tok];
    l2 = l == -INFINITY ? INFINITY : l * kLog2e;
  }
  if (lane == 0) {
    ld[tile * kLd + r] = l2;
    ld[tile * kLd + kRows + r] = delta;
  }
}

// ---------------------------------------------------------------------------
// 2. dK/dV: the key tiles `pair` and n_kt - 1 - pair of KV head blockIdx.y,
//    sequence blockIdx.z
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreadsKV, 1) flash_bwd_dkdv_sm90_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap omap,
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const float* __restrict__ ld, bf16* __restrict__ dk, bf16* __restrict__ dv,
    const int* __restrict__ q_offset, const int* __restrict__ kv_len, int Sq, int Sk, int HKV,
    int BQ, int gshift, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sm = aligned_smem(smem);
  const uint32_t base = fct::smem_u32(sm);
  const uint32_t full = base + FULL_OFF, fixbar = base + FIX_BAR_OFF;
  const int g = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int n_kt = (Sk + kRows - 1) / kRows, n_qt = (Sq + BQ - 1) / BQ;
  // blocks from the middle pair out: the pairs of an offset call that see
  // the most queries start first
  const int pair = gridDim.x - 1 - blockIdx.x;
  const int n_walks = pair == n_kt - 1 - pair ? 1 : 2;
  const int qoff = q_offset[b], kvl = min(kv_len[b], Sk);
  // the block's stream: walk 0's query tiles [tb0, n_qt), then walk 1's
  const int tb0 = walk_begin(walk_k0(0, pair, n_kt), kvl, qoff, BQ, n_qt);
  const int tb1 = walk_begin(walk_k0(1, pair, n_kt), kvl, qoff, BQ, n_qt);
  const int n0 = n_qt - tb0, n_pos = n0 + (n_walks == 2 ? n_qt - tb1 : 0);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) fct::mbar_init(full + 8 * s, 1);  // the expect_tx
    fct::mbar_init(fixbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wtid = tid % kWarpgroup, warp = wtid / 32, lane = wtid % 32;
  const int r_a = warp * 16 + lane / 4;  // this thread's keys of a tile: r_a, r_a + 8
  const float c2 = scale * kLog2e;
  // the consumer index as a value ptxas knows to be warp-uniform: the
  // products below run under it, and under a branch it cannot prove uniform
  // ptxas serializes every wgmma
  const int c = __shfl_sync(0xffffffffu, tid / kWarpgroup, 0);
  const float* ld_bg = ld + ((long)b * HKV + g) * n_qt * kLd;
  // position it of the stream into stage it % kStages: the query tile's Q
  // and dO by TMA, its lse and delta by a bulk copy. Consumer c takes the
  // positions of its parity, so stages c and c + 2 are its own: its first
  // thread fills them, the next position but one as each is read.
  const auto fetch = [&](int it) {
    const int s = it % kStages, t = it < n0 ? tb0 + it : tb1 + it - n0;
    const uint32_t bar = full + 8 * s, st = base + RING_OFF + s * 2 * kTile;
    fct::mbar_expect_tx(bar, 2 * kTile + kLd * 4);
    for (int h = 0; h < 2; ++h) {
      fct::tma_load_4d(st + h * kPanel, &qmap, bar, h * 64, g << gshift, t * BQ, b);
      fct::tma_load_4d(st + kTile + h * kPanel, &omap, bar, h * 64, g << gshift, t * BQ, b);
    }
    fct::bulk_load(base + LD_OFF + s * kLd * 4, ld_bg + (long)t * kLd, kLd * 4, bar);
  };
  if (tid == 0) {  // the walks' K and V, once
    fct::mbar_expect_tx(fixbar, n_walks * 2 * kTile);
    for (int w = 0; w < n_walks; ++w) {
      const uint32_t kv = base + FIX_OFF + w * 2 * kTile;
      const int k0 = walk_k0(w, pair, n_kt);
      for (int h = 0; h < 2; ++h) {
        fct::tma_load_4d(kv + h * kPanel, &kmap, fixbar, h * 64, g, k0, b);
        fct::tma_load_4d(kv + kTile + h * kPanel, &vmap, fixbar, h * 64, g, k0, b);
      }
    }
  }
  if (wtid == 0) {
    if (c < n_pos) fetch(c);
    if (c + 2 < n_pos) fetch(c + 2);
  }
  float dka[D / 2], dva[D / 2];  // dK and dV [64 keys x 128 d], fp32
  float st[32], dpt[32];         // S^T (then P^T) and dP^T [64 keys x 64 query rows]
  uint32_t pf[4][4], sf[4][4];   // P^T and dS^T as A fragments
  fct::mbar_wait(fixbar, 0);
  int it0 = 0;  // the walk's first position in the block's stream
  for (int w = 0; w < n_walks; ++w) {
    zero(dka);
    zero(dva);
    const uint32_t kv = base + FIX_OFF + w * 2 * kTile;  // K, then V at + kTile
    const int k0 = walk_k0(w, pair, n_kt), tb = w == 0 ? tb0 : tb1;
    // this consumer's positions it = it0 + i of the walk: those of its parity
    for (int i = (c - it0) & 1; i < n_qt - tb; i += 2) {
      const int it = it0 + i, t = tb + i, s = it % kStages;
      const uint32_t qs = base + RING_OFF + s * 2 * kTile;  // Q, then dO at + kTile
      fct::mbar_wait(full + 8 * s, (it / kStages) & 1);
      // four steps, so that S^T, dP^T and the fragments are never all live
      // (the registers note): (1) S^T = K Q^T, then P^T
      wgmma_fence();
      tile_abt(st, kv, qs);
      wgmma_commit_wait();
      fct::fence_regs(st);
      const float* lds = reinterpret_cast<const float*>(sm + LD_OFF + s * kLd * 4);
      const int pos0 = qoff + t * BQ;
      const bool masked = k0 + kRows - 1 > pos0 || k0 + kRows > kvl;
      if (masked) {
        probs_t<true>(st, pf, lds, k0 + r_a, kvl, pos0, gshift, c2, lane);
      } else {
        probs_t<false>(st, pf, lds, k0 + r_a, kvl, pos0, gshift, c2, lane);
      }
      // (2) dV += P^T dO; (3) dP^T = V dO^T, then dS^T
      fct::fence_regs(dva);
      fence_frags(pf);
      wgmma_fence();
      tile_ft(dva, pf, qs + kTile);
      wgmma_commit_wait();
      fct::fence_regs(dva);
      wgmma_fence();
      tile_abt(dpt, kv + kTile, qs + kTile);
      wgmma_commit_wait();
      fct::fence_regs(dpt);
      if (masked) {
        dscores_t<true>(st, dpt, sf, lds, lane);
      } else {
        dscores_t<false>(st, dpt, sf, lds, lane);
      }
      // (4) dK += dS^T Q
      fct::fence_regs(dka);
      fence_frags(sf);
      wgmma_fence();
      tile_ft(dka, sf, qs);
      wgmma_commit_wait();
      fct::fence_regs(dka);
      // every warp of this consumer is done with the stage: its next tile
      named_sync(2 + c, kWarpgroup);
      if (wtid == 0 && it + kStages < n_pos) fetch(it + kStages);
    }
    it0 += n_qt - tb;
    // the two consumers' sums through the walk's K/V tiles, in a fixed
    // order: once both are done with them, consumer 1's dV goes to
    // consumer 0, which adds it and sends its dK back in the same slots
    named_sync(1, 2 * kWarpgroup);
    float4* ex = reinterpret_cast<float4*>(sm + FIX_OFF + w * 2 * kTile) + wtid;
    if (c == 1) {
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        ex[i * kWarpgroup] = make_float4(dva[4 * i], dva[4 * i + 1], dva[4 * i + 2], dva[4 * i + 3]);
      }
    }
    named_sync(1, 2 * kWarpgroup);
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const float4 x = ex[i * kWarpgroup];
        dva[4 * i] += x.x;
        dva[4 * i + 1] += x.y;
        dva[4 * i + 2] += x.z;
        dva[4 * i + 3] += x.w;
        ex[i * kWarpgroup] = make_float4(dka[4 * i], dka[4 * i + 1], dka[4 * i + 2], dka[4 * i + 3]);
      }
    }
    named_sync(1, 2 * kWarpgroup);
    const long row0 = ((long)b * Sk + k0) * HKV + g;  // key k0 of KV head g
    if (c == 0) {
      store_rows(dv + row0 * D, (long)HKV * D, dva, 1.f, Sk - k0, r_a, lane);
    } else {
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const float4 x = ex[i * kWarpgroup];
        dka[4 * i] += x.x;
        dka[4 * i + 1] += x.y;
        dka[4 * i + 2] += x.z;
        dka[4 * i + 3] += x.w;
      }
      store_rows(dk + row0 * D, (long)HKV * D, dka, scale, Sk - k0, r_a, lane);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dQ: `tiles` query tiles of KV head blockIdx.y, sequence blockIdx.z;
//    blockIdx.x counts from the last tiles, which see the most keys
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_sm90_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap omap,
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const float* __restrict__ ld, bf16* __restrict__ dq, const int* __restrict__ q_offset,
    const int* __restrict__ kv_len, int Sq, int Sk, int H, int HKV, int BQ, int gshift,
    int tiles, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sm = aligned_smem(smem);
  const uint32_t base = fct::smem_u32(sm);
  const uint32_t full = base + FULL_OFF, empty = base + EMPTY_OFF, fixbar = base + FIX_BAR_OFF;
  const int g = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int t0 = (gridDim.x - 1 - blockIdx.x) * tiles;
  const int active = min(tiles, n_qt - t0);  // consumers with a tile
  const int qoff = q_offset[b], kvl = min(kv_len[b], Sk);
  // the keys the block walks: those its last row sees, cut at kv_len (every
  // consumer walks them all, keys past its own rows masked)
  const int block_keys = min(kvl, qoff + min(Sq, (t0 + active) * BQ));
  const int n_kt = (max(block_keys, 0) + kRows - 1) / kRows;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      fct::mbar_init(full + 8 * s, 1);
      fct::mbar_init(empty + 8 * s, active * kWarpgroup);  // every consumer thread
    }
    fct::mbar_init(fixbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = tid / kWarpgroup - 1;

  if (wg < 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 0) {
      fct::mbar_expect_tx(fixbar, active * 2 * kTile);
      for (int w = 0; w < active; ++w) {
        const uint32_t qd = base + FIX_OFF + w * 2 * kTile;
        for (int h = 0; h < 2; ++h) {
          fct::tma_load_4d(qd + h * kPanel, &qmap, fixbar, h * 64, g << gshift, (t0 + w) * BQ, b);
          fct::tma_load_4d(qd + kTile + h * kPanel, &omap, fixbar, h * 64, g << gshift,
                           (t0 + w) * BQ, b);
        }
      }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) fct::mbar_wait(empty + 8 * s, ((kt / kStages) + 1) & 1);
        const uint32_t bar = full + 8 * s, st = base + RING_OFF + s * 2 * kTile;
        fct::mbar_expect_tx(bar, 2 * kTile);
        for (int h = 0; h < 2; ++h) {
          fct::tma_load_4d(st + h * kPanel, &kmap, bar, h * 64, g, kt * kRows, b);
          fct::tma_load_4d(st + kTile + h * kPanel, &vmap, bar, h * 64, g, kt * kRows, b);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int c = __shfl_sync(0xffffffffu, wg, 0);  // warp-uniform, as in the dK/dV body
  if (c >= active) return;
  const int wtid = tid % kWarpgroup, warp = wtid / 32, lane = wtid % 32;
  const int t = t0 + c;
  const uint32_t qs = base + FIX_OFF + c * 2 * kTile;  // Q, then dO at + kTile
  // this thread's rows a and b of the tile (r_a, r_a + 8): token t * BQ +
  // (r >> gshift), head g * group + r % group, their base-2 lse and delta
  const int r_a = warp * 16 + lane / 4;
  const float* ld_t = ld + (((long)b * HKV + g) * n_qt + t) * kLd;
  const float l2[2] = {ld_t[r_a], ld_t[r_a + 8]};
  const float dl[2] = {ld_t[kRows + r_a], ld_t[kRows + r_a + 8]};
  const int pos[2] = {qoff + t * BQ + (r_a >> gshift), qoff + t * BQ + ((r_a + 8) >> gshift)};
  const int pos_lo = qoff + t * BQ;
  const float c2 = scale * kLog2e;
  float dqa[D / 2];      // dQ [64 rows x 128 d], fp32
  float sc[32], dp[32];  // S and dP [64 rows x 64 keys]
  uint32_t sf[4][4];     // dS as A fragments
  zero(dqa);
  fct::mbar_wait(fixbar, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % kStages, k0 = kt * kRows;
    const uint32_t ks = base + RING_OFF + s * 2 * kTile;  // K, then V at + kTile
    fct::mbar_wait(full + 8 * s, (kt / kStages) & 1);
    wgmma_fence();
    tile_abt(sc, qs, ks);                  // S = Q K^T
    tile_abt(dp, qs + kTile, ks + kTile);  // dP = dO V^T
    wgmma_commit_wait();
    fct::fence_regs(sc);
    fct::fence_regs(dp);
    if (k0 + kRows - 1 > pos_lo || k0 + kRows > kvl) {
      grads_q<true>(sc, dp, sf, l2, dl, pos, k0, kvl, c2, lane);
    } else {
      grads_q<false>(sc, dp, sf, l2, dl, pos, k0, kvl, c2, lane);
    }
    // the last tile's K rows at or past kv_len (the sequence's own rows
    // below Sk) may hold anything: zeros before dS K
    if (k0 + kRows > kvl) zero_k_tail(sm + RING_OFF + s * 2 * kTile, kvl - k0, c, wtid);
    fct::fence_regs(dqa);
    fence_frags(sf);
    wgmma_fence();
    tile_ft(dqa, sf, ks);  // dQ += dS K
    wgmma_commit_wait();
    fct::fence_regs(dqa);
    fct::mbar_arrive(empty + 8 * s);  // this stage's K and V are read
  }
  // rows of tokens below Sq: dq [B, Sq, H, D] at token t * BQ + (r >> gshift),
  // head g * group + r % group
  const int group = 1 << gshift;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r_a + 8 * half, tok = t * BQ + (r >> gshift);
    if (tok >= Sq) continue;
    bf16* row = dq + (((long)b * Sq + tok) * H + (g << gshift) + (r & (group - 1))) * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * i + 2 * (lane % 4)) = __floats2bfloat162_rn(
          dqa[4 * i + 2 * half] * scale, dqa[4 * i + 2 * half + 1] * scale);
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// [B, S, n, 128] bf16 as a 4D tensor map read in boxes of 64 d x `heads` x
// `rows` tokens of one sequence
bool make_seq_map(CUtensorMap* map, const void* ptr, int B, int S, int n, uint32_t heads,
                  uint32_t rows) {
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)n, (uint64_t)S, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)D * 2, (uint64_t)n * D * 2, (uint64_t)S * n * D * 2};
  const uint32_t box[4] = {64, heads, rows, 1};
  return fct::make_map_4d(map, ptr, dims, strides, box);
}

}  // namespace

// the arguments of flash_attention_bwd_bf16 (flash_attention.cu; `scratch`
// in delta's place holds B * Hkv * ceil(Sq / BQ) * 128 floats), then the
// query tokens of a 64-row tile (BQ) and the dQ pass's query tiles a block
// (1 or 2). Refuses (cudaErrorInvalidValue) a call it does not take: causal,
// head_dim 128, 64-row tiles, 16-byte aligned operands.
extern "C" int flash_attention_bwd_bf16_sm90(const void* q, const void* k, const void* v,
                                             const void* out, const void* dout, const void* lse,
                                             void* scratch, void* dq, void* dk, void* dv,
                                             const void* q_offset, const void* kv_len, int B,
                                             int Sq, int Sk, int H, int HKV, int D_, int causal,
                                             int BQ, int tiles, float scale, void* stream) {
  if (D_ != D || causal != 1 || B < 1 || B > 65535 || Sq < 1 || Sk < 1 || HKV < 1 ||
      HKV > 65535 || H % HKV != 0 || BQ < 1 || (H / HKV) * BQ != kRows || tiles < 1 ||
      tiles > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out) && aligned16(dout) &&
        aligned16(lse) && aligned16(scratch) && aligned16(dq) && aligned16(dk) &&
        aligned16(dv))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the runtime calls first: they make the device's primary context current
  // on this thread (autograd runs the backward on a thread of its own, where
  // none may be yet), which cuTensorMapEncodeTiled needs
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_sm90_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_bwd_dq_sm90_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int group = H / HKV;  // divides 64: a power of 2
  int gshift = 0;
  while ((1 << gshift) < group) ++gshift;
  CUtensorMap qmap, omap, kmap, vmap;
  if (!make_seq_map(&qmap, q, B, Sq, H, group, BQ) || !make_seq_map(&omap, dout, B, Sq, H, group, BQ) ||
      !make_seq_map(&kmap, k, B, Sk, HKV, 1, kRows) || !make_seq_map(&vmap, v, B, Sk, HKV, 1, kRows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* o = static_cast<const bf16*>(out);
  const bf16* dop = static_cast<const bf16*>(dout);
  float* ld = static_cast<float*>(scratch);
  const int* qo = static_cast<const int*>(q_offset);
  const int* kl = static_cast<const int*>(kv_len);
  const int n_qt = (Sq + BQ - 1) / BQ, n_kt = (Sk + kRows - 1) / kRows;

  const long rows = (long)B * HKV * n_qt * kRows;  // a multiple of 4
  flash_bwd_prep_sm90_kernel<<<(unsigned)(rows / 4), 128, 0, st>>>(
      o, dop, static_cast<const float*>(lse), ld, B, Sq, H, HKV, BQ, gshift, n_qt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_sm90_kernel<<<dim3((n_kt + 1) / 2, HKV, B), kThreadsKV, kSmem, st>>>(
      qmap, omap, kmap, vmap, ld, static_cast<bf16*>(dk), static_cast<bf16*>(dv), qo, kl, Sq, Sk,
      HKV, BQ, gshift, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_sm90_kernel<<<dim3((n_qt + tiles - 1) / tiles, HKV, B), kThreads, kSmem, st>>>(
      qmap, omap, kmap, vmap, ld, static_cast<bf16*>(dq), qo, kl, Sq, Sk, H, HKV, BQ, gshift,
      tiles, scale);
  return static_cast<int>(cudaGetLastError());
}
