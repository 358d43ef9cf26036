// Attention over the bf16 paged KV cache for Hopper, at prefill: K1's
// chunks of 64-row query tiles, and the prefill tiles of K3's ragged rounds;
// and K7's forward, causal attention over contiguous K/V.
//
// Replaces the TPU kernel finchat_tpu/ops/paged_attention.py
// paged_flash_attention (_paged_kernel) for calls whose query tiles hold 64
// rows (group * tile tokens) over pages of whole 64-key tiles with no page
// split — every bf16 prefill chunk at page 128. The routing rule
// (ops/paged_attention.attention_kernel_for) sends decode to
// attention_decode_sm90.cu and every other call (fewer rows, pages of part
// tiles) to paged_attention.cu. It computes what _paged_kernel computes for
// a prefill block: causal GQA with absolute positions (query row i of
// sequence b at q_offset[b] + i), keys at or past kv_len[b] masked, fp32
// online softmax, the probabilities rounded to bf16 before the PV product
// (the reference casts its weights to the value dtype), bf16 output; a row
// with no valid key writes zeros, and padding tokens of a partial query tile
// write nothing.
//
// What bounds it on the H100: tensor-core operations. A 4 x 512 chunk at
// q_offset 1024 does 4 * 32 * 512 * ~1,280 keys * 128 * 4 = 43 GFLOP
// (0.043 ms at 989 TFLOP/s) on 24 MB of K/V (0.007 ms at 3.35 TB/s). The
// body it replaces (attention_common.cuh attend_tile_tc) loaded each 64-key
// tile synchronously into padded shared memory between two barriers,
// multiplied with mma.sync through ldmatrix, and fetched every K/V tile of
// the prefix once per 64-row query tile.
//
// Design: a block holds `tiles` (1 or 2, ops/paged_attention
// .query_tiles_per_block: one only where the call's one-tile blocks fit in
// one wave) consecutive 64-row query tiles of one sequence and KV head, so
// each K/V tile is fetched once for up to 128 rows; blocks are
// issued heaviest first (the last query tiles of a chunk see the most
// keys). The block walks the keys of its longest query tile (cut at kv_len
// and at the tile's last position) in K/V tiles of 128 keys. A block is
// three warpgroups:
// - a producer (one thread of warpgroup 0, its registers given up with
//   setmaxnreg) keeps a ring of kStages K/V tiles of KV head g in flight by
//   TMA, 32 KB of K and 32 KB of V a stage, over tensor maps of the layer's
//   pages viewed as [P * page_size, Hkv * 128], in boxes of 64 keys x 64 d
//   with the 128-byte swizzle: a box never straddles a page (page_size % 64
//   == 0), and boxes wholly past the block's keys are never fetched, so the
//   trash page (physical page 0, where the page table's tail points) is
//   never read. Each stage completes on its "full" mbarrier and is refilled
//   once every consumer thread has arrived on its "empty" one.
// - a consumer warpgroup per query tile (4 warps, 16 rows each). The boxes
//   land in the layout wgmma reads: each tile is two 64-column panels [128
//   key][64 d] of 128-byte rows, 16-byte chunk c of row r at c ^ (r % 8).
//   For S = Q K^T that is K-major K; for O += P V the same layout of V
//   ([key][d], as it lies in the page) is read as an MN-major operand
//   (wgmma's transpose bit, which 16-bit types allow), so V needs no
//   transpose pass. S = Q K^T runs as m64n128k16 with Q in registers (loaded
//   once, the A-fragment layout), the online softmax in registers (base 2,
//   the scale folded into log2(e)), O += P V as m64n128k16 with P in
//   registers (rounded to bf16); fp32 accumulators. Step t issues S(t + 1)
//   and P(t) V(t) back to back and takes the softmax of S(t + 1) once both
//   are done; the two consumers run unsynchronized, so one's softmax runs
//   under the other's products.
// - What paces it is the softmax side, not the products or the fetch
//   (tools/attention_bf16_diag.py), so the body spends as few instructions
//   a score as it can: 128-key tiles (the row reductions, the rescale of O
//   and the waits are paid once for twice the keys of a 64-key tile), one
//   ex2.approx per score, the rescale of O skipped where no row of a warp
//   moved its maximum, masks only in tiles that cross kv_len or a position.
//   Three ways to overlap more were tried and dropped: taking the softmax
//   under this warpgroup's own P V (FA3's order) makes ptxas serialize the
//   products; taking turns between the consumers with named barriers, and
//   three consumers (Q in shared memory to fit their registers, 64-key
//   tiles), measured slower.
// - In the last tile, V's rows at or past kv_len, and those of a box not
//   fetched, are zeroed before the P V product (both consumers write the
//   same zeros), so no stale value reaches a sum (0 x NaN is NaN); their
//   scores are masked.
// Every mbarrier wait traps after ~2^34 cycles instead of hanging.
//
// The ragged entry (ragged_paged_attention_bf16_sm90) replaces
// finchat_tpu/ops/ragged_paged_attention.py ragged_flash_attention
// (_ragged_kernel) for the prefill tiles of a bf16 round of 64-row tiles
// over pages of whole 64-key tiles (ops/paged_attention.ragged_kernels_for);
// the round's rows of one token go to the ragged entry of
// attention_decode_sm90.cu in a second launch. A block takes `tiles` (1
// or 2, ops/paged_attention.query_tiles_per_block over the bucket's tiles)
// consecutive tiles of one row: block j takes tile j and, at two, the
// row's next tile too, unless tile j is an odd tile of its row (the block
// before took it). Their tokens, row and positions come from the round's
// tile descriptors (ops/ragged_paged_attention.ragged_tiles), the row's
// page table and kv_len, the keys the block walks cut at its last tile's
// last position; the same producer, consumers, ring and waits as a chunk's
// block. Tiles of one-token rows return at once; a padding tile (row R)
// writes zeros for its KV head's columns, so the output needs no memset.
// Blocks are issued from the last tile, so a row's later tiles, which see
// the most keys, start first.
//
// The contiguous entry (flash_attention_bf16_sm90) replaces
// finchat_tpu/ops/flash_attention.py flash_attention (_flash_kernel) for its
// causal calls of 64-row tiles (ops/flash_attention.flash_kernel_for): the
// training step's forward (Llama-3-8B, S = 2048: 34 GFLOP on 25 MB, 0.035
// ms at the operations bound) and the one-shot forward. It is a chunk's
// block over another key map: q [B, Sq, H, D] is a chunk's [B, C, H, D],
// and contiguous k, v [B, Sk, Hkv, D] viewed as [B * Sk, Hkv * 128] are a
// page pool of one Sk-row page per sequence (key j of sequence b at row b *
// Sk + j), in the same boxes. A box that starts inside sequence b may run
// past Sk into sequence b + 1 (TMA zero-fills only past the whole tensor):
// kv_len is cut at Sk, so such rows lie at or past kv_len, in the last tile,
// where their scores are masked and V's rows zeroed, and no value of the
// next sequence reaches a sum. Each consumer also writes its rows'
// log-sum-exp, m + ln(l) = ln 2 * (m * scale * log2 e + log2 l) from the
// base-2 state (-inf for a row without a valid key), which K7's backward
// (flash_attention_bwd_sm90.cu, or flash_attention.cu by name) reads.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"
#include "sm90_pipeline.cuh"

namespace {

constexpr int D = 128;            // head_dim
constexpr int kRows = 64;         // query rows of a tile: one warpgroup, 16 rows a warp
constexpr int kKeys = 128;        // keys per K/V tile
constexpr int kBox = 64;          // keys per TMA box (a page holds whole boxes)
constexpr int kStages = 3;        // K/V tiles in the ring
constexpr int kWarpgroup = 128;   // threads
constexpr int kMaxTiles = 2;      // query tiles (consumer warpgroups) a block
constexpr int kThreads = (1 + kMaxTiles) * kWarpgroup;
// registers per thread after the split (setmaxnreg): the producer gives up
// what the consumers' accumulators take; 40 + 2 * 232 <= 3 * 168, the
// launch's 168 a thread at 384 threads
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// one ring stage: K as two [128 key][64 d] panels, then V likewise; a box
// of 64 keys fills half a panel
constexpr int kPanel = kKeys * 128;
constexpr int kBoxBytes = kBox * 128;
constexpr int kV = 2 * kPanel;
constexpr int kStage = 2 * kV;
// dynamic shared memory from a 1024-byte aligned base (the swizzle atoms):
// the ring, its full and empty barriers, each query tile's token count and
// positions
constexpr int RING_OFF = 0;
constexpr int FULL_OFF = RING_OFF + kStages * kStage;
constexpr int EMPTY_OFF = FULL_OFF + kStages * 8;
constexpr int NTOK_OFF = EMPTY_OFF + kStages * 8;
constexpr int POS_OFF = NTOK_OFF + 16;
constexpr int kSmem = POS_OFF + kMaxTiles * kRows * 4 + 1024;  // + alignment slack
static_assert(kStage % 1024 == 0 && kBoxBytes % 1024 == 0 && FULL_OFF % 8 == 0, "layout");

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

using fct::exp2_approx;
using fct::wgmma_m64n128k16_rs;

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* smem) {
  return smem + (((fct::smem_u32(smem) + 1023u) & ~1023u) - fct::smem_u32(smem));
}

// the MN-major descriptor of V's [16 key][128 d] slice starting at `addr`
// (1024-byte aligned): 8-key groups 1024 bytes apart (stride offset), the
// second 64-column panel kPanel bytes on (leading offset), 128-byte swizzle
__device__ __forceinline__ uint64_t v_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(kPanel >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// keeps the compiler from moving definitions of P's fragments past the
// fence, into a stage of products in flight
__device__ __forceinline__ void fence_frags(uint32_t (&f)[kKeys / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(f[kk][i])::"memory");
  }
}

// S [64 x 128] = Q K^T for the K tile of the stage at `stage` (issued, not
// waited on)
__device__ __forceinline__ void issue_scores(float (&s)[kKeys / 2],
                                             const uint32_t (&qf)[D / 16][4], uint32_t stage) {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    // a 16-wide d slice starts 32 bytes further into its panel's rows; the
    // first product overwrites s
    wgmma_m64n128k16_rs<0>(s, qf[ks], fct::sw128_desc(stage + (ks / 4) * kPanel) + 2 * (ks % 4),
                           ks > 0);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// O += P V for the V tile of the stage at `stage` (issued, not waited on)
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pf)[kKeys / 16][4],
                                         uint32_t stage) {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    wgmma_m64n128k16_rs<1>(o, pf[kk], v_desc(stage + kV + kk * 16 * 128), 1);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// O so far, to the maxima of the tile whose P is multiplied next; skipped
// where no row of the warp moved its maximum (corr == 1), as most do once a
// row has seen a few tiles
__device__ __forceinline__ void rescale(float (&o)[D / 2], const float (&corr)[2]) {
  if (!__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) return;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    o[4 * n] *= corr[0];
    o[4 * n + 1] *= corr[0];
    o[4 * n + 2] *= corr[1];
    o[4 * n + 3] *= corr[1];
  }
}

// The online softmax of one K/V tile of scores, in registers: masks keys
// at or past kv_len and past each row's position (only where the tile
// crosses one), updates the running maxima m (raw scores) and sums l, and
// leaves P (base-2 exponentials rounded to bf16) in wgmma's A-fragment
// layout and each row's rescale factor for the output so far.
__device__ __forceinline__ void softmax_tile(float (&sc)[kKeys / 2], uint32_t (&pf)[kKeys / 16][4],
                                             float (&m)[2], float (&l)[2], float (&corr)[2],
                                             int k0, int kv_len, const int (&pos)[2],
                                             int pos_lo, float scale2, int lane) {
  if (k0 + kKeys > kv_len || k0 + kKeys - 1 > pos_lo) {
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // e / 2: row a or b
        const int key = k0 + j * 8 + 2 * (lane % 4) + (e & 1);
        if (!(key < kv_len && key <= pos[e / 2])) sc[4 * j + e] = -INFINITY;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // two chains of maxima and of sums, then the quad's four lanes
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      mx[j & 1] = fmaxf(mx[j & 1], fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
    }
    float mr = fmaxf(mx[0], mx[1]);
    mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 1));
    mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 2));
    const float mn = fmaxf(m[r], mr);
    corr[r] = exp2_approx((m[r] - mn) * scale2);
    const float off = -mn * scale2;
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // a masked score is -inf: its exponential is 0
        float& x = sc[4 * j + 2 * r + e];
        x = exp2_approx(fmaf(x, scale2, off));
        sum[j & 1] += x;
      }
    }
    float sr = sum[0] + sum[1];
    sr += __shfl_xor_sync(0xffffffffu, sr, 1);
    sr += __shfl_xor_sync(0xffffffffu, sr, 2);
    l[r] = l[r] * corr[r] + sr;
    m[r] = mn;
  }
  // P: rows a and b of 16 keys a step
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    pf[kk][0] = fct::pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
    pf[kk][1] = fct::pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pf[kk][2] = fct::pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pf[kk][3] = fct::pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// boxes of the tile at k0 that hold keys the block needs (1 or 2)
__device__ __forceinline__ int boxes(int k0, int block_keys) {
  return block_keys - k0 > kBox ? 2 : 1;
}

// zeros over V's rows [live, 128) of the stage at `stage` (this warpgroup's
// share), visible to wgmma once every thread of warpgroup w passed the
// named barrier 1 + w
__device__ __forceinline__ void zero_v_tail(unsigned char* stage, int live, int w, int wtid) {
  for (int idx = wtid; idx < (kKeys - live) * 16; idx += kWarpgroup) {
    const int r = live + idx / 16, c = idx % 16;
    *reinterpret_cast<uint4*>(stage + kV + (c / 8) * kPanel + r * 128 +
                              (((c % 8) ^ (r & 7)) << 4)) = make_uint4(0u, 0u, 0u, 0u);
  }
  fct::fence_proxy_async();
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + w), "n"(kWarpgroup) : "memory");
}

// Where a sequence's key lies in the tensor maps' rows: through its page
// table (the paged and ragged entries), or at row0 + key of the contiguous
// K/V viewed as [B * Sk, Hkv * 128] (the contiguous entry, row0 = b * Sk).
struct PageKeys {
  const int* __restrict__ pt_row;
  int ps;
  __device__ __forceinline__ int operator()(int key) const {
    return pt_row[key / ps] * ps + key % ps;
  }
};
struct ContigKeys {
  int row0;
  __device__ __forceinline__ int operator()(int key) const { return row0 + key; }
};

// The producer: the block's K/V tiles of KV head g into the ring by TMA, a
// stage refilled once its previous tile is released; boxes wholly past the
// block's keys are not fetched.
template <class Keys>
__device__ __forceinline__ void produce(const CUtensorMap* kmap, const CUtensorMap* vmap,
                                        Keys keys, int g, int n_tiles, int block_keys,
                                        uint32_t ring, uint32_t full, uint32_t empty) {
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    if (t >= kStages) fct::mbar_wait(empty + 8 * s, ((t / kStages) + 1) & 1);
    const int k0 = t * kKeys, nb = boxes(k0, block_keys);
    const uint32_t bar = full + 8 * s;
    fct::mbar_expect_tx(bar, nb * 4 * kBoxBytes);
    for (int h = 0; h < nb; ++h) {
      const int key = k0 + h * kBox;
      const int row = keys(key);
      const uint32_t st = ring + s * kStage + h * kBoxBytes;
      fct::tma_load_2d(st, kmap, bar, g * D, row);
      fct::tma_load_2d(st + kPanel, kmap, bar, g * D + 64, row);
      fct::tma_load_2d(st + kV, vmap, bar, g * D, row);
      fct::tma_load_2d(st + kV + kPanel, vmap, bar, g * D + 64, row);
    }
  }
}

// A consumer: query tile w (rows gq * bq + i, group * bq == 64) of KV head g
// over the block's n_tiles K/V tiles of the ring (keys past its own rows'
// positions are masked). Writes its bf16 output at out (bq tokens of
// tok_stride) and, with LSE, each row's natural log-sum-exp at lse[h *
// lse_stride + i] (-inf for a row without a valid key).
template <bool LSE>
__device__ __forceinline__ void consume(const __nv_bfloat16* __restrict__ q_tile,
                                        __nv_bfloat16* __restrict__ out, long tok_stride,
                                        const int* s_pos, int n_tok, int bq, int group, int g,
                                        int kv_len, int n_tiles, int block_keys, float scale,
                                        int w, unsigned char* sm, uint32_t ring, uint32_t full,
                                        uint32_t empty, float* __restrict__ lse,
                                        long lse_stride) {
  const int wtid = threadIdx.x % kWarpgroup, warp = wtid / 32, lane = wtid % 32;
  // this thread's two rows of its warp's 16 (accumulator rows lane / 4, + 8)
  const int r_a = warp * 16 + lane / 4, r_b = r_a + 8;
  const int i_a = r_a % bq, i_b = r_b % bq;
  const bool v_a = i_a < n_tok, v_b = i_b < n_tok;
  const int pos[2] = {v_a ? s_pos[i_a] : -1, v_b ? s_pos[i_b] : -1};
  const int pos_lo = min(v_a ? pos[0] : 0x7fffffff, v_b ? pos[1] : 0x7fffffff);
  // Q as wgmma's A fragments, straight from global memory (read once): for
  // each 16-wide d slice ks, rows a and b at d = 16ks + 2(lane % 4) and + 8
  const uint32_t* qa = reinterpret_cast<const uint32_t*>(
      q_tile + (long)i_a * tok_stride + (long)(g * group + r_a / bq) * D + 2 * (lane % 4));
  const uint32_t* qb = reinterpret_cast<const uint32_t*>(
      q_tile + (long)i_b * tok_stride + (long)(g * group + r_b / bq) * D + 2 * (lane % 4));
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    qf[ks][0] = v_a ? qa[8 * ks] : 0u;
    qf[ks][1] = v_b ? qb[8 * ks] : 0u;
    qf[ks][2] = v_a ? qa[8 * ks + 4] : 0u;
    qf[ks][3] = v_b ? qb[8 * ks + 4] : 0u;
  }

  const float scale2 = scale * kLog2e;  // scores in base 2
  // per row a, b: running maximum of the raw scores, sum of the base-2
  // exponentials, and the rescale factor of the tile the softmax last took
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f}, corr[2] = {1.f, 1.f};
  // O [64 x 128]: o[4n + e] row a, o[4n + 2 + e] row b, d 8n + 2(lane % 4) + e
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  // S of a tile: sc[4j + e] row a, sc[4j + 2 + e] row b, key 8j + 2(lane % 4) + e
  float sc[kKeys / 2];
  uint32_t pf[kKeys / 16][4];  // P of the tile multiplied next

  if (n_tiles > 0) {
    fct::mbar_wait(full, 0);
    issue_scores(sc, qf, ring);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fct::fence_regs(sc);
    softmax_tile(sc, pf, m, l, corr, 0, kv_len, pos, pos_lo, scale2, lane);
  }
  // steps with a next tile: S(t + 1) and P(t) V(t) back to back, then the
  // softmax of S(t + 1)
  int t = 0;
  for (; t + 1 < n_tiles; ++t) {
    const int s = t % kStages, s1 = (t + 1) % kStages;
    fct::mbar_wait(full + 8 * s1, ((t + 1) / kStages) & 1);
    rescale(o, corr);
    fct::fence_regs(o);  // O and P are defined before the step's first product
    fence_frags(pf);
    issue_scores(sc, qf, ring + s1 * kStage);
    issue_pv(o, pf, ring + s * kStage);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fct::fence_regs(sc);
    fct::fence_regs(o);
    fct::mbar_arrive(empty + 8 * s);  // this tile's K and V are read
    softmax_tile(sc, pf, m, l, corr, (t + 1) * kKeys, kv_len, pos, pos_lo, scale2, lane);
  }
  // the last tile (the only one that can hold kv_len or an unfetched box):
  // P V alone
  if (n_tiles > 0) {
    const int s = t % kStages, k0 = t * kKeys;
    const int live = min(kv_len - k0, boxes(k0, block_keys) * kBox);
    rescale(o, corr);
    if (live < kKeys) zero_v_tail(sm + RING_OFF + s * kStage, live, w, wtid);
    fct::fence_regs(o);
    fence_frags(pf);
    issue_pv(o, pf, ring + s * kStage);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fct::fence_regs(o);
    fct::mbar_arrive(empty + 8 * s);
  }

  const long h_a = (long)g * group + r_a / bq, h_b = (long)g * group + r_b / bq;
  const float inv_a = 1.f / fmaxf(l[0], 1e-30f), inv_b = 1.f / fmaxf(l[1], 1e-30f);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int d = n * 8 + 2 * (lane % 4);
    if (v_a) {
      *reinterpret_cast<__nv_bfloat162*>(out + (long)i_a * tok_stride + h_a * D + d) =
          __floats2bfloat162_rn(o[4 * n] * inv_a, o[4 * n + 1] * inv_a);
    }
    if (v_b) {
      *reinterpret_cast<__nv_bfloat162*>(out + (long)i_b * tok_stride + h_b * D + d) =
          __floats2bfloat162_rn(o[4 * n + 2] * inv_b, o[4 * n + 3] * inv_b);
    }
  }
  if (LSE && lane % 4 == 0) {
    // m + ln(l) from the base-2 state: ln 2 * (m * scale2 + log2(l)); l is
    // the quad's sum already (softmax_tile reduces it), each lane of the
    // quad holds it
    if (v_a) lse[h_a * lse_stride + i_a] = l[0] > 0.f ? kLn2 * fmaf(m[0], scale2, log2f(l[0]))
                                                     : -INFINITY;
    if (v_b) lse[h_b * lse_stride + i_b] = l[1] > 0.f ? kLn2 * fmaf(m[1], scale2, log2f(l[1]))
                                                     : -INFINITY;
  }
}

// A block of a chunk: `tiles` consecutive query tiles (one a consumer
// warpgroup) of sequence blockIdx.z and KV head blockIdx.y; blockIdx.x
// counts from the chunk's end, so the blocks with the most keys start
// first. Paged (CONTIG false): keys through the sequence's page table.
// Contiguous (CONTIG true): each sequence is one page of PS = Sk rows (MP =
// 1, no page table), kv_len cut at Sk, and each row's log-sum-exp written
// to lse [B, H, C].
template <bool CONTIG>
__device__ __forceinline__ void chunk_block(
    unsigned char* smem, const CUtensorMap* kmap, const CUtensorMap* vmap,
    const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, const int* __restrict__ page_table,
    const int* __restrict__ q_offset, const int* __restrict__ kv_len, int C, int H, int HKV,
    int PS, int MP, int BQ, int tiles, float scale) {
  unsigned char* sm = aligned_smem(smem);
  const uint32_t base = fct::smem_u32(sm);
  const uint32_t ring = base + RING_OFF, full = base + FULL_OFF, empty = base + EMPTY_OFF;
  const int g = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int c0 = (gridDim.x - 1 - blockIdx.x) * tiles * BQ;  // the first tile's first token
  int* s_ntok = reinterpret_cast<int*>(sm + NTOK_OFF);
  int* s_pos = reinterpret_cast<int*>(sm + POS_OFF);
  // contiguous: rows at or past Sk belong to the next sequence; cut there,
  // the last tile's V rows from kv_len on are zeroed and their scores masked
  const int qoff = q_offset[b], kvl = CONTIG ? min(kv_len[b], PS) : kv_len[b];
  for (int i = tid; i < kMaxTiles * kRows; i += kThreads) {
    const int w = i / kRows, k = i % kRows;
    if (k < BQ) s_pos[i] = qoff + c0 + w * BQ + k;
    if (k == 0) s_ntok[w] = w < tiles ? max(0, min(BQ, C - c0 - w * BQ)) : 0;
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      fct::mbar_init(full + 8 * s, 1);                   // the producer's expect_tx
      fct::mbar_init(empty + 8 * s, tiles * kWarpgroup);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the keys the block walks: those of its longest query tile, cut at
  // kv_len and at the tile's last position (both consumers walk them all,
  // the shorter tile's extra keys masked)
  int block_keys = 0;
  for (int w = 0; w < tiles; ++w) {
    const int n = s_ntok[w];
    if (n > 0) block_keys = max(block_keys, min(min(MP * PS, kvl), s_pos[w * kRows + n - 1] + 1));
  }
  const int n_tiles = (block_keys + kKeys - 1) / kKeys;
  const int wg = tid / kWarpgroup - 1;  // consumer index; -1 for the producer

  if (wg < 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 0) {
      if (CONTIG) {
        produce(kmap, vmap, ContigKeys{b * PS}, g, n_tiles, block_keys, ring, full, empty);
      } else {
        produce(kmap, vmap, PageKeys{page_table + (long)b * MP, PS}, g, n_tiles, block_keys, ring,
                full, empty);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  if (wg >= tiles) return;
  const long tok = (long)H * D;
  const long tok0 = (long)b * C + c0 + (long)wg * BQ;
  consume<CONTIG>(q + tok0 * tok, out + tok0 * tok, tok, s_pos + wg * kRows, s_ntok[wg], BQ,
                  H / HKV, g, kvl, n_tiles, block_keys, scale, wg, sm, ring, full, empty,
                  CONTIG ? lse + (long)b * H * C + c0 + wg * BQ : nullptr, C);
}

__global__ void __launch_bounds__(kThreads, 1) paged_attention_bf16_sm90_kernel(
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out,
    const int* __restrict__ page_table, const int* __restrict__ q_offset,
    const int* __restrict__ kv_len, int C, int H, int HKV, int PS, int MP, int BQ, int tiles,
    float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  chunk_block<false>(smem, &kmap, &vmap, q, out, nullptr, page_table, q_offset, kv_len, C, H,
                     HKV, PS, MP, BQ, tiles, scale);
}

// contiguous causal attention: q [B, Sq, H, D], k and v [B, Sk, HKV, D] (the
// tensor maps' rows), out like q, lse [B, H, Sq]
__global__ void __launch_bounds__(kThreads, 1) flash_attention_bf16_sm90_kernel(
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, const int* __restrict__ q_offset, const int* __restrict__ kv_len,
    int Sq, int Sk, int H, int HKV, int BQ, int tiles, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  chunk_block<true>(smem, &kmap, &vmap, q, out, lse, nullptr, q_offset, kv_len, Sq, H, HKV, Sk,
                    1, BQ, tiles, scale);
}

// `tiles` consecutive 64-row ragged tiles of one row a block (one a
// consumer warpgroup); blockIdx.x counts from the last tile
__global__ void __launch_bounds__(kThreads, 1) ragged_attention_bf16_sm90_kernel(
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out,
    const int* __restrict__ page_table, const int* __restrict__ tok_pos,
    const int* __restrict__ kv_len, const int* __restrict__ tile_row,
    const int* __restrict__ tile_start, const int* __restrict__ tile_len,
    const int* __restrict__ q_start, const int* __restrict__ q_len, int R, int H, int HKV,
    int PS, int MP, int BQ, int tiles, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int j = gridDim.x - 1 - blockIdx.x, g = blockIdx.y, tid = threadIdx.x;
  const int row = tile_row[j], ts = tile_start[j], n_tok = tile_len[j];
  const long tok = (long)H * D;
  if (row >= R) {  // a padding tile: zeros for this KV head's columns, 16 bytes a store
    const int w = (H / HKV) * D / 8;
    for (int idx = tid; idx < n_tok * w; idx += kThreads) {
      const int i = idx / w, c = idx % w;
      *reinterpret_cast<uint4*>(out + (long)(ts + i) * tok + (long)g * w * 8 + c * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  if (q_len[row] == 1) return;  // a one-token row: the decode body's ragged entry
  // the row's tiles lie at tile_start q_start + k * BQ, in consecutive
  // descriptors: at two a block, an even tile k takes tile k + 1 too
  int n_tok2 = 0;
  if (tiles == 2) {
    if (((ts - q_start[row]) / BQ) & 1) return;
    if (j + 1 < gridDim.x && tile_row[j + 1] == row) n_tok2 = tile_len[j + 1];
  }
  const int active = n_tok2 > 0 ? 2 : 1;  // consumer warpgroups with a tile
  unsigned char* sm = aligned_smem(smem);
  const uint32_t base = fct::smem_u32(sm);
  const uint32_t ring = base + RING_OFF, full = base + FULL_OFF, empty = base + EMPTY_OFF;
  int* s_pos = reinterpret_cast<int*>(sm + POS_OFF);
  for (int i = tid; i < n_tok + n_tok2; i += kThreads) {
    s_pos[i < n_tok ? i : kRows + i - n_tok] = tok_pos[ts + i];  // tile 2's tokens follow
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      fct::mbar_init(full + 8 * s, 1);
      fct::mbar_init(empty + 8 * s, active * kWarpgroup);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the block's keys: cut at kv_len and at its last tile's last (largest)
  // position (the first tile walks them all, the extra keys masked)
  const int kvl = kv_len[row];
  const int last = active == 2 ? s_pos[kRows + n_tok2 - 1] : s_pos[n_tok - 1];
  const int block_keys = min(min(MP * PS, kvl), last + 1);
  const int n_tiles = (max(block_keys, 0) + kKeys - 1) / kKeys;
  const int wg = tid / kWarpgroup - 1;
  if (wg < 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 0) produce(&kmap, &vmap, PageKeys{page_table + (long)row * MP, PS}, g, n_tiles,
                          block_keys, ring, full, empty);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  if (wg >= active) return;
  const long tok0 = ts + (long)wg * BQ;
  consume<false>(q + tok0 * tok, out + tok0 * tok, tok, s_pos + wg * kRows, wg ? n_tok2 : n_tok,
                 BQ, H / HKV, g, kvl, n_tiles, block_keys, scale, wg, sm, ring, full, empty,
                 nullptr, 0);
}

// the kernel's shared memory opted into, then K and V as [rows, Hkv * 128]
// from k and v (a layer's pages, rows P * page_size; or contiguous K/V, rows
// B * Sk), read in 64 x 64 boxes. The runtime call comes first: it makes the
// device's primary context current on this thread (autograd's thread, under
// remat, may have none yet), which cuTensorMapEncodeTiled needs.
int prepare_maps(CUtensorMap* kmap, CUtensorMap* vmap, const __nv_bfloat16* k,
                 const __nv_bfloat16* v, long rows, int HKV, const void* kernel) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!fct::make_map(kmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, k, (uint64_t)rows,
                     (uint64_t)HKV * D, kBox, 64, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !fct::make_map(vmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, v, (uint64_t)rows,
                     (uint64_t)HKV * D, kBox, 64, CU_TENSOR_MAP_SWIZZLE_128B)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// a layer's pages as the tensor maps' rows
int prepare_page_maps(CUtensorMap* kmap, CUtensorMap* vmap, const void* k_pages,
                      const void* v_pages, int layer, int HKV, int P, int PS,
                      const void* kernel) {
  const long layer_off = (long)layer * P * PS * HKV * D;
  return prepare_maps(kmap, vmap, static_cast<const __nv_bfloat16*>(k_pages) + layer_off,
                      static_cast<const __nv_bfloat16*>(v_pages) + layer_off, (long)P * PS, HKV,
                      kernel);
}

// the calls every entry takes: head_dim 128, 64-row tiles, 16-byte aligned
// operands (the paged entries also whole 64-key boxes in a page)
bool takes(const void* q, const void* k, const void* v, const void* out, int H, int HKV,
           int D_, int BQ) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  return D_ == D && HKV > 0 && H % HKV == 0 && (H / HKV) * BQ == kRows && aligned(q) &&
         aligned(k) && aligned(v) && aligned(out);
}

}  // namespace

// the arguments of paged_attention_bf16 (paged_attention.cu), then the
// query tiles a block (1 or 2); KT, the partials and pages_per_split are
// unused: this kernel takes no splits. Refuses (cudaErrorInvalidValue) a
// call it does not take: head_dim 128, 64-row tiles, whole 64-key boxes in
// a page, no split, 16-byte aligned operands.
extern "C" int paged_attention_bf16_sm90(const void* q, const void* k_pages, const void* v_pages,
                                         void* out, void* part_acc, void* part_ml,
                                         const void* page_table, const void* q_offset,
                                         const void* kv_len, int layer, int B, int C, int H,
                                         int HKV, int D_, int P, int PS, int KT, int MP, int BQ,
                                         int splits, int pages_per_split, int tiles,
                                         float scale, void* stream) {
  (void)part_acc, (void)part_ml, (void)KT, (void)pages_per_split;
  if (!takes(q, k_pages, v_pages, out, H, HKV, D_, BQ) || PS % kBox != 0 || splits != 1 ||
      tiles < 1 || tiles > kMaxTiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap kmap, vmap;
  const int err =
      prepare_page_maps(&kmap, &vmap, k_pages, v_pages, layer, HKV, P, PS,
                        reinterpret_cast<const void*>(paged_attention_bf16_sm90_kernel));
  if (err != 0) return err;
  const dim3 grid((C + tiles * BQ - 1) / (tiles * BQ), HKV, B);
  paged_attention_bf16_sm90_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      kmap, vmap, static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(out),
      static_cast<const int*>(page_table), static_cast<const int*>(q_offset),
      static_cast<const int*>(kv_len), C, H, HKV, PS, MP, BQ, tiles, scale);
  return static_cast<int>(cudaGetLastError());
}

// the arguments of ragged_paged_attention_bf16 (ragged_paged_attention.cu)
// with each row's first token and token count (q_start, q_len [R]) after
// its pointers, then the tiles a block (1 or 2); KT and T are unused.
// Refuses (cudaErrorInvalidValue) a call it does not take, as the paged
// entry does.
extern "C" int ragged_paged_attention_bf16_sm90(
    const void* q, const void* k_pages, const void* v_pages, void* out, const void* page_table,
    const void* tok_pos, const void* kv_len, const void* tile_row, const void* tile_start,
    const void* tile_len, const void* q_start, const void* q_len, int layer, int T, int R,
    int H, int HKV, int D_, int P, int PS, int KT, int MP, int NT, int BQ, int tiles,
    float scale, void* stream) {
  (void)T, (void)KT;
  if (!takes(q, k_pages, v_pages, out, H, HKV, D_, BQ) || PS % kBox != 0 || NT < 1 ||
      tiles < 1 || tiles > kMaxTiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap kmap, vmap;
  const int err =
      prepare_page_maps(&kmap, &vmap, k_pages, v_pages, layer, HKV, P, PS,
                        reinterpret_cast<const void*>(ragged_attention_bf16_sm90_kernel));
  if (err != 0) return err;
  ragged_attention_bf16_sm90_kernel<<<dim3(NT, HKV), kThreads, kSmem,
                                      static_cast<cudaStream_t>(stream)>>>(
      kmap, vmap, static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(out),
      static_cast<const int*>(page_table), static_cast<const int*>(tok_pos),
      static_cast<const int*>(kv_len), static_cast<const int*>(tile_row),
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_len),
      static_cast<const int*>(q_start), static_cast<const int*>(q_len), R, H, HKV, PS, MP, BQ,
      tiles, scale);
  return static_cast<int>(cudaGetLastError());
}

// the arguments of flash_attention_fwd_bf16 (flash_attention.cu), then the
// query tokens of a 64-row tile (BQ) and the query tiles a block (1 or 2).
// Refuses (cudaErrorInvalidValue) a call it does not take: causal, head_dim
// 128, 64-row tiles, 16-byte aligned operands.
extern "C" int flash_attention_bf16_sm90(const void* q, const void* k, const void* v, void* out,
                                         void* lse, const void* q_offset, const void* kv_len,
                                         int B, int Sq, int Sk, int H, int HKV, int D_,
                                         int causal, int BQ, int tiles, float scale,
                                         void* stream) {
  if (!takes(q, k, v, out, H, HKV, D_, BQ) || causal != 1 || B < 1 || B > 65535 || Sq < 1 ||
      Sk < 1 || tiles < 1 || tiles > kMaxTiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap kmap, vmap;
  const int err = prepare_maps(&kmap, &vmap, static_cast<const __nv_bfloat16*>(k),
                               static_cast<const __nv_bfloat16*>(v), (long)B * Sk, HKV,
                               reinterpret_cast<const void*>(flash_attention_bf16_sm90_kernel));
  if (err != 0) return err;
  const dim3 grid((Sq + tiles * BQ - 1) / (tiles * BQ), HKV, B);
  flash_attention_bf16_sm90_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      kmap, vmap, static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), static_cast<const int*>(q_offset),
      static_cast<const int*>(kv_len), Sq, Sk, H, HKV, BQ, tiles, scale);
  return static_cast<int>(cudaGetLastError());
}
