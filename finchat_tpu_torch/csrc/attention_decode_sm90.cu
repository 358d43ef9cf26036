// Decode attention for Hopper: K1 and K4 at C = 1 (one query token per
// sequence), over a bf16 cache or an int8 cache with its scale planes.
//
// Replaces the TPU kernel finchat_tpu/ops/paged_attention.py
// paged_flash_attention (_paged_kernel) and, for the int8 cache,
// paged_flash_attention_q8 (_paged_kernel_q8) for decode calls whose pages
// hold whole 64-key tiles; the routing rule
// (ops/paged_attention.attention_kernel_for) sends every other call to
// paged_attention.cu or attention_q8_sm90.cu. It computes what
// they compute at C = 1: the query of sequence b sits at q_offset[b], keys
// at or past kv_len[b] (or past the query) are masked, a sequence without a
// key writes zeros, the online softmax runs in fp32, P is rounded to bf16
// before the PV product (the reference casts its weights to the value
// dtype), the output is bf16. On the int8 cache each K/V value is exactly
// bf16(float(q8) * scale[head][token]), the TPU kernel's cast point.
//
// What bounds it on the H100: the KV bytes. A decode call reads every live
// key of every sequence once per KV head — 512 bytes a key in bf16, 264 in
// int8 with its two fp32 scales — and does 4 * group * 128 FLOPs on it
// (4 FLOPs a byte at Llama-3's group of 4 in bf16), far under the ~295 a
// byte where the tensor cores would bind. By Little's law the card needs
// 3.35 TB/s x ~1 us of latency ~= 3.3 MB of reads in flight, ~25 KB an SM.
// The older body (attention_common.cuh attend_tile) staged each tile
// synchronously with nothing in flight while it computed, left half its
// threads idle in the score pass at 4 rows, and split at a fixed 4 pages.
//
// Design: one block of 4 warps per (split, KV head, sequence); the split
// (pages_per_split) comes from ops/paged_attention.decode_split, a pure
// function of B, Hkv, max_pages, page_size and the SM count, and a block
// past its sequence's last live key returns at once.
// - An asynchronous ring of 64-key K/V tiles in shared memory (3 stages of
//   32 KB for bf16, 4 of 16.5 KB for int8, raw bytes plus the two 256-byte
//   scale rows): every thread issues its share as 16-byte cp.async copies
//   and arrives on the stage's mbarrier when they land; tiles t + 1 .. t +
//   stages - 1 are in flight while tile t is used — 64 KB a block in bf16,
//   ~50 KB in int8, and with 2 blocks an SM (218-250 registers a thread)
//   ~100-130 KB an SM against the ~25 KB needed. A tile never straddles
//   a page; tiles wholly past the sequence's keys are never fetched; keys
//   past kv_len inside the last tile are masked and their V values zeroed,
//   so no stale or trash value reaches a sum.
// - Every warp works: warp w takes keys [16w, 16w + 16) of every tile and
//   keeps its own (m, l, acc); the 4 warps merge through shared memory at
//   the end. Products are mma.sync m16n8k16 with the group's rows (4 for
//   Llama-3) padded to 16: decode is bytes-bound, the padded rows cost
//   tensor-core time the card has to spare. Q stays in registers (loaded
//   once), K and V go from shared memory straight into B fragments with no
//   ldmatrix: the QK product is summed over a permuted head dimension (a
//   thread's four values of a k-step are d = 32t + 4ks .. +3, Q permuted
//   alike) and the PV product's output columns are permuted (column g of
//   n-tile j is d = 16g + j), so each thread reads whole
//   16-byte chunks of K and V. Chunks are XOR-swizzled as they are copied
//   so those reads are free of bank conflicts.
// - int8: each staged value is converted once a block — by the one thread
//   whose fragment holds it — through the byte permute of sm90_pipeline.cuh
//   and one fp32 product with its key's scale.
// - Partials: a sequence whose keys fit one split writes its bf16 output
//   from the block; otherwise each live split writes fp32 (m, l, acc) (m in
//   base 2) and a second kernel in this file merges the live splits.
// - Rows: the kernels read a sequence's query, output, position and length
//   through a policy: PagedRows (sequence b is token b, at q_offset[b]) for
//   the paged entries, RaggedRows for the ragged one.
// The ragged entry (ragged_paged_attention_decode_bf16_sm90) replaces
// finchat_tpu/ops/ragged_paged_attention.py ragged_flash_attention
// (_ragged_kernel) for the rows of one token of a bf16 round of 64-row
// tiles over pages of whole 64-key tiles (ops/paged_attention
// .ragged_kernels_for); its prefill tiles go to attention_bf16_sm90.cu in
// the launch before. A round's row r is a sequence: its query and output at
// its first packed token q_start[r], its position tok_pos[q_start[r]] (in
// the compacted coordinates of a bounded-KV row), kv_len[r] and page-table
// row r; blocks of rows that are not one token long return at once, and
// the split is decode_split's with the round's R rows as B.
// Every mbarrier wait traps after ~2^34 cycles instead of hanging. Defining
// FCT_DECODE_NO_FETCH (no copies: the ring is read as it stands) or
// FCT_DECODE_NO_PRODUCTS (no mma: fragments are read, converted and folded
// into one word) gives the diagnostic builds of
// finchat_tpu_torch/tools/attention_decode_diag.py; they compute garbage.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"
#include "sm90_pipeline.cuh"

namespace {

constexpr int D = 128;            // head_dim
constexpr int kKeys = 64;         // keys per tile (a page holds whole tiles)
constexpr int kWarps = 4;         // warp w takes keys [16w, 16w + 16) of every tile
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxGroup = 16;     // query rows of a block: the mma's 16 rows
constexpr float kLog2e = 1.4426950408889634f;
// the warps' merge scratch, over the ring once it is drained: each lane's 64
// accumulators (a padded stride of 68 floats: conflict-free float4 stores),
// then each warp's (m, l) per row
constexpr int kAccStride = 68;
constexpr int kScratch = (kWarps * 32 * kAccStride + kWarps * kMaxGroup * 2) * 4;

// Physical 16-byte chunk of chunk c of key row r in a stage. Each makes the
// fragment reads below hit 8 distinct 16-byte bank groups in every phase of
// 8 lanes (lanes 0-7 are rows g = 0, 1 by t = 0..3, and so on).
// bf16 K rows (16 chunks; thread t reads chunks 4t .. 4t + 3 of rows g, g + 8)
__device__ __forceinline__ int swz_k16(int r, int c) {
  return c ^ (((c >> 3) & 1) << 1) ^ (r & 1);
}
// bf16 V rows (16 chunks; thread (g, t) reads chunks 2g, 2g + 1 of rows 2t, 2t + 1, 2t + 8,
// 2t + 9)
__device__ __forceinline__ int swz_v16(int r, int c) {
  const int t = (r >> 1) & 3;
  return c ^ ((t & 1) | ((t & 2) << 1));
}
// int8 K rows (8 chunks; thread t reads chunks 2t, 2t + 1)
__device__ __forceinline__ int swz_k8(int r, int c) { return c ^ (r & 1); }
// int8 V rows (8 chunks; thread (g, t) reads chunk g of rows 2t, 2t + 1, 2t + 8, 2t + 9)
__device__ __forceinline__ int swz_v8(int r, int c) { return c ^ (((r >> 1) & 3) << 1); }

// two bf16 halves, one from each word: the low ones (e = 0) or the high ones (e = 1)
__device__ __forceinline__ uint32_t pair(uint32_t lo, uint32_t hi, int e) {
  return __byte_perm(lo, hi, e ? 0x7632 : 0x5410);
}

__device__ __forceinline__ float deq(uint32_t w, int j, float sc) {
  return fct::byte_as_float(w ^ 0x80808080u, j, fct::kInt8Bias) * sc;
}

// bf16 pages [P, page_size, Hkv * D] of one layer
struct CacheBf16 {
  static constexpr int kStages = 3;
  static constexpr int kRow = D * 2;           // bytes of one key's slice of a head
  static constexpr int kV = kKeys * kRow;      // V's offset in a stage
  static constexpr int kStage = 2 * kKeys * kRow;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  long hd;  // Hkv * D
  int ps;

  // the copies of the tile at keys [k0, k0 + 64) of head g into `stage`
  __device__ __forceinline__ void fetch(const int* __restrict__ pt_row, int k0, int g,
                                        uint32_t stage, int tid) const {
#ifndef FCT_DECODE_NO_FETCH
    const long phys = pt_row[k0 / ps];
    const long row0 = (phys * ps + k0 % ps) * hd + (long)g * D;
#pragma unroll
    for (int n = 0; n < 2 * kKeys * 16 / kThreads; ++n) {
      const int idx = tid + n * kThreads;
      const int which = idx / (kKeys * 16);  // 0: K, 1: V
      const int r = (idx / 16) % kKeys, c = idx % 16;
      const __nv_bfloat16* src = (which ? v : k) + row0 + (long)r * hd + c * 8;
      const int p = which ? swz_v16(r, c) : swz_k16(r, c);
      fct::cp_async16(stage + which * kV + r * kRow + p * 16, src);
    }
#endif
  }

  // B fragments of S = Q K^T for key row r: b[ks] holds d 32t + 4ks .. + 3
  __device__ __forceinline__ void k_frags(const unsigned char* st, int r, int t,
                                          uint32_t (&b)[8][2]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4 w = *reinterpret_cast<const uint4*>(st + r * kRow + swz_k16(r, 4 * t + i) * 16);
      b[2 * i][0] = w.x;
      b[2 * i][1] = w.y;
      b[2 * i + 1][0] = w.z;
      b[2 * i + 1][1] = w.w;
    }
  }

  // B fragments of O += P V: b[j] holds column d = 16g + j of keys r, r + 1
  // (b[j][0]) and r + 8, r + 9 (b[j][1]); a key at or past k_hi reads zero
  __device__ __forceinline__ void v_frags(const unsigned char* st, int r, int g, int key,
                                          int k_hi, uint32_t (&b)[16][2]) const {
    uint32_t w[4][8];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int rr = r + (x & 1) + 8 * (x >> 1);
      const bool ok = key + (rr - r) < k_hi;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 u = *reinterpret_cast<const uint4*>(st + kV + rr * kRow +
                                                        swz_v16(rr, 2 * g + h) * 16);
        w[x][4 * h] = ok ? u.x : 0u;
        w[x][4 * h + 1] = ok ? u.y : 0u;
        w[x][4 * h + 2] = ok ? u.z : 0u;
        w[x][4 * h + 3] = ok ? u.w : 0u;
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      b[j][0] = pair(w[0][j / 2], w[1][j / 2], j & 1);
      b[j][1] = pair(w[2][j / 2], w[3][j / 2], j & 1);
    }
  }
};

// int8 pages [P, page_size, Hkv * D] of one layer with per-token-per-head
// fp32 scales [P, spad, page_size]
struct CacheInt8 {
  static constexpr int kStages = 4;
  static constexpr int kRow = D;
  static constexpr int kV = kKeys * D;
  static constexpr int kKS = 2 * kKeys * D;    // the K scale row, then the V one
  static constexpr int kStage = kKS + 2 * kKeys * 4;
  const int8_t* k;
  const int8_t* v;
  const float* ks;
  const float* vs;
  long hd;
  int ps;
  int spad;

  __device__ __forceinline__ void fetch(const int* __restrict__ pt_row, int k0, int g,
                                        uint32_t stage, int tid) const {
#ifndef FCT_DECODE_NO_FETCH
    const long phys = pt_row[k0 / ps];
    const int off0 = k0 % ps;
    const long row0 = (phys * ps + off0) * hd + (long)g * D;
#pragma unroll
    for (int n = 0; n < 2 * kKeys * 8 / kThreads; ++n) {
      const int idx = tid + n * kThreads;
      const int which = idx / (kKeys * 8);
      const int r = (idx / 8) % kKeys, c = idx % 8;
      const int8_t* src = (which ? v : k) + row0 + (long)r * hd + c * 16;
      const int p = which ? swz_v8(r, c) : swz_k8(r, c);
      fct::cp_async16(stage + which * kV + r * kRow + p * 16, src);
    }
    if (tid < 2 * kKeys * 4 / 16) {  // the two scale rows, 16 chunks each
      const int which = tid / 16, c = tid % 16;
      const float* src = (which ? vs : ks) + (phys * spad + g) * ps + off0 + c * 4;
      fct::cp_async16(stage + kKS + which * kKeys * 4 + c * 16, src);
    }
#endif
  }

  __device__ __forceinline__ void k_frags(const unsigned char* st, int r, int t,
                                          uint32_t (&b)[8][2]) const {
    const float sc = reinterpret_cast<const float*>(st + kKS)[r];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint4 u = *reinterpret_cast<const uint4*>(st + r * kRow + swz_k8(r, 2 * t + i) * 16);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        b[4 * i + m][0] = fct::pack_bf16(deq(w[m], 0, sc), deq(w[m], 1, sc));
        b[4 * i + m][1] = fct::pack_bf16(deq(w[m], 2, sc), deq(w[m], 3, sc));
      }
    }
  }

  __device__ __forceinline__ void v_frags(const unsigned char* st, int r, int g, int key,
                                          int k_hi, uint32_t (&b)[16][2]) const {
    const float* sv = reinterpret_cast<const float*>(st + kKS + kKeys * 4);
    uint32_t w[4][4];
    float sc[4];
    bool ok[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int rr = r + (x & 1) + 8 * (x >> 1);
      const uint4 u = *reinterpret_cast<const uint4*>(st + kV + rr * kRow + swz_v8(rr, g) * 16);
      w[x][0] = u.x;
      w[x][1] = u.y;
      w[x][2] = u.z;
      w[x][3] = u.w;
      sc[x] = sv[rr];
      ok[x] = key + (rr - r) < k_hi;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float f[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) f[x] = ok[x] ? deq(w[x][j / 4], j % 4, sc[x]) : 0.f;
      b[j][0] = fct::pack_bf16(f[0], f[1]);
      b[j][1] = fct::pack_bf16(f[2], f[3]);
    }
  }
};

// Where sequence b of a paged call lives: token b, at q_offset[b].
struct PagedRows {
  const int* q_offset;
  const int* kv_len;
  __device__ __forceinline__ bool at(int b, long& tok, int& pos, int& kv) const {
    tok = b;
    pos = q_offset[b];
    kv = kv_len[b];
    return true;
  }
};

// Where row b of a ragged round lives: its first packed token q_start[b],
// at that token's position; false for a row that is not one token long
// (the prefill body's ragged entry takes its tiles).
struct RaggedRows {
  const int* tok_pos;
  const int* kv_len;
  const int* q_start;
  const int* q_len;
  __device__ __forceinline__ bool at(int b, long& tok, int& pos, int& kv) const {
    if (q_len[b] != 1) return false;
    tok = q_start[b];
    pos = tok_pos[tok];
    kv = kv_len[b];
    return true;
  }
};

// keys the sequence's query attends: below kv_len, at most its own
// position, inside its page-table row
__device__ __forceinline__ int row_keys(int q_pos, int kv, int max_keys) {
  return max(0, min(min(kv, q_pos + 1), max_keys));
}

// splits that hold a live key (at least one: a sequence without keys still
// writes its zeros from split 0)
__device__ __forceinline__ int live_splits(int keys, int span) {
  return max(1, (keys + span - 1) / span);
}

template <class Cache, class Rows>
__global__ void __launch_bounds__(kThreads, 2) attention_decode_sm90_kernel(
    const __nv_bfloat16* __restrict__ q, Cache cache, Rows rows, __nv_bfloat16* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_ml,
    const int* __restrict__ page_table, int B, int H, int HKV, int MP, int pps, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int S = Cache::kStages;
  const int s = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  long tok;  // the sequence's query and output token
  int pos, kv;
  if (!rows.at(b, tok, pos, kv)) return;
  const int span = pps * cache.ps;
  const int keys = row_keys(pos, kv, MP * cache.ps);
  const int live = live_splits(keys, span);
  if (s >= live) return;
  const int k_lo = s * span, k_hi = min(keys, k_lo + span);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kKeys - 1) / kKeys : 0;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gr = lane / 4, t = lane % 4;
  const int group = H / HKV;
  const uint32_t base = fct::smem_u32(smem);
  const uint32_t bars = base + S * Cache::kStage;
  const int* pt_row = page_table + (long)b * MP;

  if (tid == 0) {
    for (int i = 0; i < S; ++i) fct::mbar_init(bars + 8 * i, kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int i = 0; i < S - 1 && i < n_tiles; ++i) {
    cache.fetch(pt_row, k_lo + i * kKeys, g, base + i * Cache::kStage, tid);
    fct::cp_async_arrive(bars + 8 * i);
  }

  // Q as A fragments, read once: rows gr and gr + 8 of the group (zero past
  // it), d 32t .. 32t + 31 — qf[ks] holds d 32t + 4ks .. + 3, the
  // permutation the K fragments share
  const bool v0 = gr < group, v1 = gr + 8 < group;
  uint32_t qw[2][16];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const bool ok = x ? v1 : v0;
    const uint4* src = reinterpret_cast<const uint4*>(
        q + (tok * H + (long)g * group + gr + 8 * x) * D + 32 * t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4 u = ok ? src[i] : make_uint4(0u, 0u, 0u, 0u);
      qw[x][4 * i] = u.x;
      qw[x][4 * i + 1] = u.y;
      qw[x][4 * i + 2] = u.z;
      qw[x][4 * i + 3] = u.w;
    }
  }
  uint32_t qf[8][4];
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    qf[ks][0] = qw[0][2 * ks];
    qf[ks][1] = qw[1][2 * ks];
    qf[ks][2] = qw[0][2 * ks + 1];
    qf[ks][3] = qw[1][2 * ks + 1];
  }

  const float scale2 = scale * kLog2e;  // scores in base 2
  float m0 = -1e30f, m1 = -1e30f, l0 = 0.f, l1 = 0.f;
  // O: o[j][0] row gr at d 32t + j, o[j][1] row gr at d 32t + 16 + j,
  // o[j][2], o[j][3] the same for row gr + 8
  float o[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#ifdef FCT_DECODE_NO_PRODUCTS
  uint32_t sink = 0;
#endif

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % S;
    // every warp is done with tile i - 1: its stage takes tile i + S - 1
    __syncthreads();
    const int nx = i + S - 1;
    if (nx < n_tiles) {
      const int ns = nx % S;
      cache.fetch(pt_row, k_lo + nx * kKeys, g, base + ns * Cache::kStage, tid);
      fct::cp_async_arrive(bars + 8 * ns);
    }
    fct::mbar_wait(bars + 8 * st, (i / S) & 1);
    const int kw = k_lo + i * kKeys + 16 * warp;  // this warp's first key
    if (kw >= k_hi) continue;
    const unsigned char* stage = smem + st * Cache::kStage;

    // S [16 rows x 16 keys] = Q K^T: sc[n][e] row gr, sc[n][2 + e] row gr + 8,
    // key kw + 8n + 2t + e
    float sc[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      uint32_t kb[8][2];
      cache.k_frags(stage, 16 * warp + 8 * n + gr, t, kb);
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
#ifdef FCT_DECODE_NO_PRODUCTS
        sink ^= kb[ks][0] ^ kb[ks][1];
#else
        fct::mma_bf16(sc[n], qf[ks], kb[ks][0], kb[ks][1]);
#endif
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = kw + 8 * n + 2 * t + e < k_hi;
        sc[n][e] = ok ? sc[n][e] * scale2 : -INFINITY;
        sc[n][2 + e] = ok ? sc[n][2 + e] * scale2 : -INFINITY;
        mx0 = fmaxf(mx0, sc[n][e]);
        mx1 = fmaxf(mx1, sc[n][2 + e]);
      }
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[n][e] = sc[n][e] == -INFINITY ? 0.f : exp2f(sc[n][e] - mn0);
        sc[n][2 + e] = sc[n][2 + e] == -INFINITY ? 0.f : exp2f(sc[n][2 + e] - mn1);
        sum0 += sc[n][e];
        sum1 += sc[n][2 + e];
      }
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, x);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, x);
    }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      o[j][0] *= c0;
      o[j][1] *= c0;
      o[j][2] *= c1;
      o[j][3] *= c1;
    }
    // O += P V over the warp's 16 keys: P rounded to bf16 as A fragments
    const uint32_t pf[4] = {fct::pack_bf16(sc[0][0], sc[0][1]), fct::pack_bf16(sc[0][2], sc[0][3]),
                            fct::pack_bf16(sc[1][0], sc[1][1]), fct::pack_bf16(sc[1][2], sc[1][3])};
    uint32_t vb[16][2];
    cache.v_frags(stage, 16 * warp + 2 * t, gr, kw + 2 * t, k_hi, vb);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#ifdef FCT_DECODE_NO_PRODUCTS
      sink ^= vb[j][0] ^ vb[j][1] ^ pf[j & 3];
#else
      fct::mma_bf16(o[j], pf, vb[j][0], vb[j][1]);
#endif
    }
  }
#ifdef FCT_DECODE_NO_PRODUCTS
  if (sink == 0x9e3779b9u) o[0][0] += 1.f;  // keeps the folded reads alive
#endif

  // merge the 4 warps' (m, l, acc) through shared memory (the drained ring)
  __syncthreads();
  float* acc_s = reinterpret_cast<float*>(smem);
  float* ml_s = acc_s + kWarps * 32 * kAccStride;
  float* mine = acc_s + (warp * 32 + lane) * kAccStride;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    *reinterpret_cast<float4*>(mine + 4 * j) = make_float4(o[j][0], o[j][1], o[j][2], o[j][3]);
  }
  if (t == 0) {
    ml_s[(warp * kMaxGroup + gr) * 2] = m0;
    ml_s[(warp * kMaxGroup + gr) * 2 + 1] = l0;
    ml_s[(warp * kMaxGroup + gr + 8) * 2] = m1;
    ml_s[(warp * kMaxGroup + gr + 8) * 2 + 1] = l1;
  }
  __syncthreads();
  for (int idx = tid; idx < group * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    // the lane and accumulator holding (r, d): row r % 8 of thread t = d / 32
    const int jj = d % 32;
    const int at = ((r % 8) * 4 + d / 32) * kAccStride + 4 * (jj % 16) + jj / 16 + 2 * (r / 8);
    float m_star = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_star = fmaxf(m_star, ml_s[(w * kMaxGroup + r) * 2]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(ml_s[(w * kMaxGroup + r) * 2] - m_star);
      l += ml_s[(w * kMaxGroup + r) * 2 + 1] * f;
      a += acc_s[w * 32 * kAccStride + at] * f;
    }
    const long h = (long)g * group + r;
    if (live == 1) {
      out[(tok * H + h) * D + d] = __float2bfloat16(a / fmaxf(l, 1e-30f));
    } else {
      const long row = ((long)s * B + b) * H + h;
      part_acc[row * D + d] = a;
      if (d == 0) {
        part_ml[row * 2] = m_star;
        part_ml[row * 2 + 1] = l;
      }
    }
  }
}

// out = sum_s acc_s 2^(m_s - m*) / sum_s l_s 2^(m_s - m*) over the live
// splits of sequences whose keys span more than one; one block per (sequence,
// query head), one thread per column
template <class Rows>
__global__ void __launch_bounds__(D) attention_decode_sm90_merge(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    __nv_bfloat16* __restrict__ out, Rows rows, int B, int H, int max_keys, int span) {
  const int b = blockIdx.x, h = blockIdx.y, d = threadIdx.x;
  long tok;
  int pos, kv;
  if (!rows.at(b, tok, pos, kv)) return;
  const int live = live_splits(row_keys(pos, kv, max_keys), span);
  if (live == 1) return;  // the split's block wrote the output
  float m_star = -INFINITY;
  for (int s = 0; s < live; ++s) m_star = fmaxf(m_star, part_ml[(((long)s * B + b) * H + h) * 2]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < live; ++s) {
    const long row = ((long)s * B + b) * H + h;
    const float f = exp2f(part_ml[row * 2] - m_star);
    l += part_ml[row * 2 + 1] * f;
    a += part_acc[row * D + d] * f;
  }
  out[(tok * H + h) * D + d] = __float2bfloat16(a / fmaxf(l, 1e-30f));
}

struct Args {
  const void* q;
  void* out;
  float* part_acc;
  float* part_ml;
  const int* page_table;
  int B, C, H, HKV, D, PS, MP, splits, pps;
  float scale;
  cudaStream_t stream;
};

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// the calls this kernel takes (the wrapper routes every other one
// elsewhere): one query token, head_dim 128, a group of at most 16 rows,
// pages of whole 64-key tiles, splits covering the page-table row, 16-byte
// aligned operands
bool takes(const Args& a, const void* k, const void* v) {
  return a.C == 1 && a.D == D && a.HKV > 0 && a.H % a.HKV == 0 && a.H / a.HKV <= kMaxGroup &&
         a.PS % kKeys == 0 && a.pps > 0 && a.splits > 0 && (long)a.splits * a.pps >= a.MP &&
         (a.splits == 1 || (a.part_acc != nullptr && a.part_ml != nullptr)) && aligned(a.q) &&
         aligned(a.out) && aligned(k) && aligned(v);
}

template <class Cache, class Rows>
int launch(const Args& a, const Cache& cache, const Rows& rows) {
  constexpr int smem = Cache::kStages * Cache::kStage + Cache::kStages * 8;
  static_assert(smem >= kScratch, "the merge scratch lies over the ring");
  static bool configured = false;  // the attribute, once a process
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(attention_decode_sm90_kernel<Cache, Rows>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(a.splits, a.HKV, a.B);
  attention_decode_sm90_kernel<Cache, Rows><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), cache, rows, static_cast<__nv_bfloat16*>(a.out),
      a.part_acc, a.part_ml, a.page_table, a.B, a.H, a.HKV, a.MP, a.pps, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return static_cast<int>(err);
  attention_decode_sm90_merge<Rows><<<dim3(a.B, a.H), D, 0, a.stream>>>(
      a.part_acc, a.part_ml, static_cast<__nv_bfloat16*>(a.out), rows, a.B, a.H, a.MP * a.PS,
      a.pps * a.PS);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const void* q, void* out, void* part_acc, void* part_ml, const void* page_table,
               int B, int C, int H, int HKV, int D_, int PS, int MP, int splits, int pps,
               float scale, void* stream) {
  return Args{q, out, static_cast<float*>(part_acc), static_cast<float*>(part_ml),
              static_cast<const int*>(page_table), B, C, H, HKV, D_, PS, MP, splits, pps, scale,
              static_cast<cudaStream_t>(stream)};
}

PagedRows paged_rows(const void* q_offset, const void* kv_len) {
  return PagedRows{static_cast<const int*>(q_offset), static_cast<const int*>(kv_len)};
}

CacheBf16 bf16_cache(const void* k_pages, const void* v_pages, int layer, int HKV, int P,
                     int PS) {
  const long layer_off = (long)layer * P * PS * HKV * D;
  return CacheBf16{static_cast<const __nv_bfloat16*>(k_pages) + layer_off,
                   static_cast<const __nv_bfloat16*>(v_pages) + layer_off, (long)HKV * D, PS};
}

}  // namespace

// the arguments of paged_attention_bf16 (paged_attention.cu); KT and BQ are
// unused (64-key tiles, one query token)
extern "C" int paged_attention_decode_bf16_sm90(
    const void* q, const void* k_pages, const void* v_pages, void* out, void* part_acc,
    void* part_ml, const void* page_table, const void* q_offset, const void* kv_len, int layer,
    int B, int C, int H, int HKV, int D_, int P, int PS, int KT, int MP, int BQ, int splits,
    int pages_per_split, float scale, void* stream) {
  (void)KT, (void)BQ;
  const Args a = make_args(q, out, part_acc, part_ml, page_table, B, C, H, HKV, D_, PS, MP,
                           splits, pages_per_split, scale, stream);
  if (!takes(a, k_pages, v_pages)) return static_cast<int>(cudaErrorInvalidValue);
  return launch(a, bf16_cache(k_pages, v_pages, layer, HKV, P, PS), paged_rows(q_offset, kv_len));
}

// the arguments of paged_attention_int8 (paged_attention.cu)
extern "C" int paged_attention_decode_int8_sm90(
    const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
    const void* v_scales, void* out, void* part_acc, void* part_ml, const void* page_table,
    const void* q_offset, const void* kv_len, int layer, int B, int C, int H, int HKV, int D_,
    int P, int PS, int SPAD, int KT, int MP, int BQ, int splits, int pages_per_split,
    float scale, void* stream) {
  (void)KT, (void)BQ;
  const Args a = make_args(q, out, part_acc, part_ml, page_table, B, C, H, HKV, D_, PS, MP,
                           splits, pages_per_split, scale, stream);
  if (!takes(a, k_pages, v_pages) || !aligned(k_scales) || !aligned(v_scales) || SPAD < HKV) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long layer_off = (long)layer * P * PS * HKV * D;
  const long scale_off = (long)layer * P * SPAD * PS;
  const CacheInt8 cache{static_cast<const int8_t*>(k_pages) + layer_off,
                        static_cast<const int8_t*>(v_pages) + layer_off,
                        static_cast<const float*>(k_scales) + scale_off,
                        static_cast<const float*>(v_scales) + scale_off, (long)HKV * D, PS, SPAD};
  return launch(a, cache, paged_rows(q_offset, kv_len));
}

// a bf16 ragged round's rows of one token (R rows; the other rows' blocks
// return at once): q and out packed [T, H, 128], each row at its first
// token q_start[r]; tok_pos, kv_len and the page table in the round's
// compacted coordinates; the split of decode_split(R, ...)
extern "C" int ragged_paged_attention_decode_bf16_sm90(
    const void* q, const void* k_pages, const void* v_pages, void* out, void* part_acc,
    void* part_ml, const void* page_table, const void* tok_pos, const void* kv_len,
    const void* q_start, const void* q_len, int layer, int T, int R, int H, int HKV, int D_,
    int P, int PS, int MP, int splits, int pages_per_split, float scale, void* stream) {
  (void)T;
  const Args a = make_args(q, out, part_acc, part_ml, page_table, R, 1, H, HKV, D_, PS, MP,
                           splits, pages_per_split, scale, stream);
  if (!takes(a, k_pages, v_pages)) return static_cast<int>(cudaErrorInvalidValue);
  const RaggedRows rows{static_cast<const int*>(tok_pos), static_cast<const int*>(kv_len),
                        static_cast<const int*>(q_start), static_cast<const int*>(q_len)};
  return launch(a, bf16_cache(k_pages, v_pages, layer, HKV, P, PS), rows);
}
