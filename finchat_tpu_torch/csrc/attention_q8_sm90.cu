// Attention over the int8 paged KV cache for Hopper, at full 64-row tiles:
// K4's prefill chunks and every tile of K6's ragged rounds.
//
// Replaces the TPU kernel finchat_tpu/ops/paged_attention.py
// paged_flash_attention_q8 (_paged_kernel_q8) for calls whose query tiles
// hold 64 rows (group * tile tokens) with page_size a multiple of 64 and no
// page splits, and finchat_tpu/ops/ragged_paged_attention.py
// ragged_flash_attention_q8 (_ragged_kernel_q8) for the same tiles; the
// routing rule (ops/paged_attention.attention_kernel_for) sends every other
// int8 call — decode blocks, small pages, split sequences — to
// paged_attention.cu / ragged_paged_attention.cu. It computes what those
// compute: causal GQA with absolute positions, keys at or past kv_len
// masked, each K/V value bf16(float(q8) * scale[head][token]) — the TPU
// kernels' cast point — fp32 online softmax with the probabilities rounded
// to bf16 before the PV product, bf16 output; a row with no valid key
// writes zeros, and the ragged kernel zeroes padding tokens.
//
// What bounds it on the H100: the int8 KV bytes and scales a ragged round
// reads (its decode rows), and the tensor-core operations of a prefill
// chunk. The body it replaces staged each 64-key tile synchronously — a
// thread loaded 8 bytes, re-read the key's scale per 8 values and converted
// them before a barrier, and no copy was in flight while the products ran.
//
// Design: one warpgroup (4 warps, 16 rows each) per 64-row query tile; a
// block holds two consecutive query tiles of a prefill chunk (K/V tiles
// fetched and dequantized once for 128 rows) or one ragged tile (a tile
// belongs to one row), for one KV head.
// - An asynchronous ring of kStages raw int8 tiles in shared memory. A stage
//   holds the 64-key K and V slices of head g (8 KB each) and their two
//   256-byte scale rows from the [P, spad, page_size] planes. Every thread
//   issues its share as 16-byte cp.async copies and arrives on the stage's
//   mbarrier when they land (cp.async.mbarrier.arrive.noinc); tile n +
//   kStages - 1 is in flight while tile n is multiplied. A tile never
//   straddles a page (page_size % 64 == 0), the page table picks its rows,
//   and tiles past kv_len or past the tile's largest query position are not
//   fetched.
// - One dequantization per tile, from shared memory, into the bf16 layouts
//   wgmma reads (K-major, 128-byte swizzle), each value bf16(float(q8) *
//   scale) through a byte permute (the byte under the exponent of 2^23;
//   sm90_pipeline.cuh) and one fp32 product. K keeps its [key][d] rows (two
//   64-column panels; thread t converts half t % 2 of key row t / 2, one
//   scale read, 16-byte reads from a raw row whose 16-byte chunk c sits at
//   c ^ (key % 8)); V is transposed on the way to [d][key] (each thread
//   reads four d columns of eight keys as words, and the byte permute that
//   makes each float also picks it out of its key's word — the transposing
//   producer of quant_matmul_sm90.cu, with a scale per key).
// - Products on tensor cores with wgmma: S = Q K^T as m64n64k16 with Q in
//   registers (loaded once, the A-fragment layout) and K from shared
//   memory, then the online softmax in registers (base 2, the scale folded
//   into log2(e)), then O += P V as m64n128k16 with P in registers (rounded
//   to bf16) and V^T from shared memory; fp32 accumulators.
// Every mbarrier wait traps after ~2^34 cycles instead of hanging.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"
#include "sm90_pipeline.cuh"

namespace {

constexpr int D = 128;       // head_dim
constexpr int kRows = 64;    // query rows per block: one warpgroup, 16 rows a warp
constexpr int kKeys = 64;    // keys per tile
constexpr int kStages = 4;   // raw tiles in the ring
constexpr int kWarpgroup = 128;  // threads

// one ring stage: K int8 [64][128] (chunks swizzled), V int8 [64][128], K
// scales, V scales
constexpr int RAW_V = kKeys * D;
constexpr int RAW_KS = 2 * kKeys * D;
constexpr int RAW_VS = RAW_KS + kKeys * 4;
constexpr int RAW_STAGE = RAW_VS + kKeys * 4;
// dynamic shared memory from a 1024-byte aligned base (the swizzle atoms):
// the bf16 K tile (two [64 key][64 d] panels), the bf16 V^T tile ([128 d][64
// key]), the ring, the barriers, the query tiles' token counts and positions
constexpr int K_PANEL = kKeys * 128;
constexpr int KT_OFF = 0;
constexpr int VT_OFF = KT_OFF + 2 * K_PANEL;
constexpr int RING_OFF = VT_OFF + D * 128;
constexpr int BAR_OFF = RING_OFF + kStages * RAW_STAGE;
constexpr int NTOK_OFF = BAR_OFF + kStages * 8;  // tokens of each warpgroup's query tile
constexpr int POS_OFF = NTOK_OFF + 16;           // their positions, 64 slots a warpgroup
constexpr int smem_bytes(int WG) { return POS_OFF + WG * kRows * 4 + 1024; }  // + alignment slack
static_assert(RAW_STAGE % 16 == 0 && BAR_OFF % 8 == 0, "layout");

constexpr float kLog2e = 1.4426950408889634f;

// int8 pages [P, page_size, Hkv * D] of one layer with per-token-per-head
// fp32 scales [P, spad, page_size]
struct KV8 {
  const int8_t* k;
  const int8_t* v;
  const float* ks;
  const float* vs;
  long hd;  // Hkv * D
  int ps;
  int spad;
};

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* smem) {
  return smem + (((fct::smem_u32(smem) + 1023u) & ~1023u) - fct::smem_u32(smem));
}

// d[64 x 64] (+)= A[64 x 16] (registers, the mma.sync A-fragment layout per
// warp) * B[16 x 64] (K-major in shared memory, 128-byte swizzle); d's old
// value is read only if `accumulate`
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d[64 x 128] += A[64 x 16] (registers, the mma.sync A-fragment layout per
// warp) * B[16 x 128] (K-major in shared memory, 128-byte swizzle)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// issue the copies of the tile at keys [k0, k0 + 64) of head g into the
// ring stage at `stage` (a share for each of the block's NT threads) and
// arrive on its barrier once they land
template <int NT>
__device__ __forceinline__ void fetch_tile(const KV8& kv, const int* __restrict__ pt_row, int k0,
                                           int g, uint32_t stage, uint32_t bar, int tid) {
  const long phys = pt_row[k0 / kv.ps];
  const int off0 = k0 % kv.ps;
  const long row0 = (phys * kv.ps + off0) * kv.hd + (long)g * D;
#pragma unroll
  for (int n = 0; n < 2 * kKeys * D / 16 / NT; ++n) {
    const int idx = tid + n * NT;
    const int which = idx / (kKeys * D / 16);  // 0: K, 1: V
    const int r = (idx / (D / 16)) % kKeys, c = idx % (D / 16);
    const int8_t* src = (which ? kv.v : kv.k) + row0 + (long)r * kv.hd + c * 16;
    const int slot = which ? c : c ^ (r & 7);
    fct::cp_async16(stage + which * RAW_V + r * D + (slot << 4), src);
  }
  if (tid < 2 * kKeys * 4 / 16) {  // the two scale rows, 16 chunks each
    const int which = tid / 16, c = tid % 16;
    const float* src = (which ? kv.vs : kv.ks) + ((phys * kv.spad + g) * kv.ps + off0) + c * 4;
    fct::cp_async16(stage + RAW_KS + which * kKeys * 4 + c * 16, src);
  }
  fct::cp_async_arrive(bar);
}

// 4 packed int8 values (sign bit flipped) times sc, as two bf16x2 words
__device__ __forceinline__ uint2 dequant4(uint32_t w, float sc) {
  return make_uint2(fct::pack_bf16(fct::byte_as_float(w, 0, fct::kInt8Bias) * sc,
                                   fct::byte_as_float(w, 1, fct::kInt8Bias) * sc),
                    fct::pack_bf16(fct::byte_as_float(w, 2, fct::kInt8Bias) * sc,
                                   fct::byte_as_float(w, 3, fct::kInt8Bias) * sc));
}

// K: thread t converts d columns [64h, 64h + 64) of key row r = t / 2 (h =
// t % 2) into row r of panel h; the halves visit their chunks in rotated
// order, so neither the raw reads nor the swizzled stores conflict
__device__ __forceinline__ void dequant_k(const unsigned char* stage, unsigned char* kt,
                                          int tid) {
  const int r = tid >> 1, h = tid & 1;
  const float sc = reinterpret_cast<const float*>(stage + RAW_KS)[r];
  unsigned char* dst = kt + h * K_PANEL + r * 128;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int j = (jj + 2 * h) & 3;
    const int c = 4 * h + j;  // raw 16-byte chunk: d 16c .. 16c + 15
    const uint4 w = *reinterpret_cast<const uint4*>(stage + r * D + ((c ^ (r & 7)) << 4));
    const uint2 a = dequant4(w.x ^ 0x80808080u, sc), b = dequant4(w.y ^ 0x80808080u, sc);
    const uint2 e = dequant4(w.z ^ 0x80808080u, sc), f = dequant4(w.w ^ 0x80808080u, sc);
    *reinterpret_cast<uint4*>(dst + (((2 * j) ^ (r & 7)) << 4)) = make_uint4(a.x, a.y, b.x, b.y);
    *reinterpret_cast<uint4*>(dst + (((2 * j + 1) ^ (r & 7)) << 4)) =
        make_uint4(e.x, e.y, f.x, f.y);
  }
}

// V: thread (warp w, lane l) converts d columns 4l .. 4l + 3 of keys 8c ..
// 8c + 7 for chunks c = ((l / 2 + w) % 4) + {0, 4}, into rows 4l .. 4l + 3
// of the [d][key] tile: word loads and chunk stores free of bank conflicts
__device__ __forceinline__ void dequant_vt(const unsigned char* stage, unsigned char* vt,
                                           int tid) {
  const int w = tid / 32, l = tid % 32;
  const unsigned char* raw = stage + RAW_V + 4 * l;
  const float* sv = reinterpret_cast<const float*>(stage + RAW_VS);
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int c = (((l >> 1) + w) & 3) | (u << 2);
    uint32_t r[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      r[i] = *reinterpret_cast<const uint32_t*>(raw + (8 * c + i) * D) ^ 0x80808080u;
    }
    const float4 s0 = reinterpret_cast<const float4*>(sv + 8 * c)[0];
    const float4 s1 = reinterpret_cast<const float4*>(sv + 8 * c)[1];
    const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float f[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = fct::byte_as_float(r[i], j, fct::kInt8Bias) * sc[i];
      const int n = 4 * l + j;
      *reinterpret_cast<uint4*>(vt + n * 128 + ((c ^ (n & 7)) << 4)) = make_uint4(
          fct::pack_bf16(f[0], f[1]), fct::pack_bf16(f[2], f[3]), fct::pack_bf16(f[4], f[5]),
          fct::pack_bf16(f[6], f[7]));
    }
  }
}

// WG 64-row query tiles of consecutive tokens (rows gq * bq + i of each,
// group * bq == 64), warpgroup w taking tile w, of KV head g over keys [0,
// min(max_pages * page_size, kv_len, largest position + 1)); the tiles
// share every K/V tile: fetched once, dequantized once (with two
// warpgroups, the first converts K and the second V). Writes the final bf16
// output of tile w at out + w * bq * tok_stride. `sm` is the 1024-byte
// aligned shared memory, holding each tile's token count and positions.
template <int WG>
__device__ __forceinline__ void attend_q8(const __nv_bfloat16* __restrict__ q_base,
                                          __nv_bfloat16* __restrict__ out_base, long tok_stride,
                                          int bq, int group, int g, const KV8& kv,
                                          const int* __restrict__ pt_row, int max_pages,
                                          int kv_len, float scale, unsigned char* sm) {
  constexpr int NT = WG * kWarpgroup;
  const int tid = threadIdx.x, wg = tid / kWarpgroup, wtid = tid % kWarpgroup;
  const int warp = wtid / 32, lane = tid % 32;
  const uint32_t base = fct::smem_u32(sm);
  const uint32_t bars = base + BAR_OFF;
  const int* s_ntok = reinterpret_cast<const int*>(sm + NTOK_OFF);
  const int* s_pos = reinterpret_cast<const int*>(sm + POS_OFF) + wg * kRows;
  const int n_tok = s_ntok[wg];
  const __nv_bfloat16* q_tile = q_base + (long)wg * bq * tok_stride;
  __nv_bfloat16* out = out_base + (long)wg * bq * tok_stride;

  // keys each tile attends, cut at its last query position; the block
  // walks the longest
  int n_tiles = 0, my_tiles = 0;
  for (int w = 0; w < WG; ++w) {
    int q_max = -1;
    for (int i = 0; i < s_ntok[w]; ++i) {
      q_max = max(q_max, reinterpret_cast<const int*>(sm + POS_OFF)[w * kRows + i]);
    }
    const int k_end = min(min(max_pages * kv.ps, kv_len), q_max + 1);
    const int tiles = k_end > 0 ? (k_end + kKeys - 1) / kKeys : 0;
    n_tiles = max(n_tiles, tiles);
    if (w == wg) my_tiles = tiles;
  }

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) fct::mbar_init(bars + 8 * s, NT);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int t = 0; t < kStages - 1 && t < n_tiles; ++t) {
    fetch_tile<NT>(kv, pt_row, t * kKeys, g, base + RING_OFF + t * RAW_STAGE, bars + 8 * t, tid);
  }

  // this thread's two rows of its warp's 16 (accumulator rows lane / 4, + 8)
  const int r_a = warp * 16 + lane / 4, r_b = r_a + 8;
  const int i_a = r_a % bq, i_b = r_b % bq;
  const bool v_a = i_a < n_tok, v_b = i_b < n_tok;
  const int pos_a = v_a ? s_pos[i_a] : -1, pos_b = v_b ? s_pos[i_b] : -1;
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
  float m_a = -1e30f, m_b = -1e30f, l_a = 0.f, l_b = 0.f;
  // O [64 x 128]: o[4n + e] row a, o[4n + 2 + e] row b, d 8n + 2(lane % 4) + e
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    // every warp is done with the previous tile: its products (waited on
    // below) and its raw stage
    __syncthreads();
    const int nt = t + kStages - 1;
    if (nt < n_tiles) {
      const int ns = nt % kStages;
      fetch_tile<NT>(kv, pt_row, nt * kKeys, g, base + RING_OFF + ns * RAW_STAGE, bars + 8 * ns,
                     tid);
    }
    fct::mbar_wait(bars + 8 * s, (t / kStages) & 1);
    const unsigned char* stage = sm + RING_OFF + s * RAW_STAGE;
    if (WG == 1 || wg == 0) dequant_k(stage, sm + KT_OFF, wtid);
    if (WG == 1 || wg == 1) dequant_vt(stage, sm + VT_OFF, wtid);
    fct::fence_proxy_async();  // the bf16 tiles, visible to wgmma
    __syncthreads();
    if (t >= my_tiles) continue;  // this warpgroup's tile needs no later keys

    // S [64 x 64] = Q K^T: sc[4j + e] row a, sc[4j + 2 + e] row b, key
    // 8j + 2(lane % 4) + e
    float sc[kKeys / 2];
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      // a 16-wide d slice starts 32 bytes further into its panel's rows; the
      // first product overwrites sc
      wgmma_m64n64k16_rs(sc, qf[ks],
                         fct::sw128_desc(base + KT_OFF + (ks / 4) * K_PANEL) + 2 * (ks % 4),
                         ks > 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fct::fence_regs(sc);

    const int k0 = t * kKeys;
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + j * 8 + 2 * (lane % 4) + e;
        const bool ok = key < kv_len;
        float& sa = sc[4 * j + e];
        float& sb = sc[4 * j + 2 + e];
        sa = (ok && key <= pos_a) ? sa * scale2 : -INFINITY;
        sb = (ok && key <= pos_b) ? sb * scale2 : -INFINITY;
        mx_a = fmaxf(mx_a, sa);
        mx_b = fmaxf(mx_b, sb);
      }
    }
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o2));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float corr_a = exp2f(m_a - mn_a), corr_b = exp2f(m_b - mn_b);
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& sa = sc[4 * j + e];
        float& sb = sc[4 * j + 2 + e];
        sa = sa == -INFINITY ? 0.f : exp2f(sa - mn_a);
        sb = sb == -INFINITY ? 0.f : exp2f(sb - mn_b);
        sum_a += sa;
        sum_b += sb;
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
      o[4 * n] *= corr_a;
      o[4 * n + 1] *= corr_a;
      o[4 * n + 2] *= corr_b;
      o[4 * n + 3] *= corr_b;
    }
    // O += P V: P rounded to bf16 in the A-fragment layout, 16 keys a step
    uint32_t pf[kKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      pf[kk][0] = fct::pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pf[kk][1] = fct::pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pf[kk][2] = fct::pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pf[kk][3] = fct::pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
    fct::fence_regs(o);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      wgmma_m64n128k16_rs(o, pf[kk], fct::sw128_desc(base + VT_OFF) + 2 * kk);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fct::fence_regs(o);
  }

  const long h_a = (long)g * group + r_a / bq, h_b = (long)g * group + r_b / bq;
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int d = n * 8 + 2 * (lane % 4);
    if (v_a) {
      *reinterpret_cast<__nv_bfloat162*>(out + (long)i_a * tok_stride + h_a * D + d) =
          __floats2bfloat162_rn(o[4 * n] / den_a, o[4 * n + 1] / den_a);
    }
    if (v_b) {
      *reinterpret_cast<__nv_bfloat162*>(out + (long)i_b * tok_stride + h_b * D + d) =
          __floats2bfloat162_rn(o[4 * n + 2] / den_b, o[4 * n + 3] / den_b);
    }
  }
}

// a prefill chunk's blocks take two consecutive query tiles each (one a
// warpgroup), so each K/V tile is fetched and dequantized once for 128 rows
constexpr int kPagedWG = 2;

__global__ void __launch_bounds__(kPagedWG * kWarpgroup, 1) paged_attention_q8_sm90_kernel(
    const __nv_bfloat16* __restrict__ q, KV8 kv, __nv_bfloat16* __restrict__ out,
    const int* __restrict__ page_table, const int* __restrict__ q_offset,
    const int* __restrict__ kv_len, int C, int H, int HKV, int MP, int BQ, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sm = aligned_smem(smem);
  const int g = blockIdx.y, b = blockIdx.z;
  const int c0 = blockIdx.x * kPagedWG * BQ;  // the first tile's first token
  int* s_ntok = reinterpret_cast<int*>(sm + NTOK_OFF);
  int* s_pos = reinterpret_cast<int*>(sm + POS_OFF);
  const int qoff = q_offset[b];
  for (int i = threadIdx.x; i < kPagedWG * kRows; i += blockDim.x) {
    const int w = i / kRows, k = i % kRows;
    if (k < BQ) s_pos[i] = qoff + c0 + w * BQ + k;
    if (k == 0) s_ntok[w] = max(0, min(BQ, C - c0 - w * BQ));
  }
  __syncthreads();
  const long tok = (long)H * D;
  const long tok0 = (long)b * C + c0;
  attend_q8<kPagedWG>(q + tok0 * tok, out + tok0 * tok, tok, BQ, H / HKV, g, kv,
                      page_table + (long)b * MP, MP, kv_len[b], scale, sm);
}

// a ragged tile belongs to one row: one tile a block
__global__ void __launch_bounds__(kWarpgroup, 2) ragged_attention_q8_sm90_kernel(
    const __nv_bfloat16* __restrict__ q, KV8 kv, __nv_bfloat16* __restrict__ out,
    const int* __restrict__ page_table, const int* __restrict__ tok_pos,
    const int* __restrict__ kv_len, const int* __restrict__ tile_row,
    const int* __restrict__ tile_start, const int* __restrict__ tile_len, int R, int H, int HKV,
    int MP, int BQ, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int j = blockIdx.x, g = blockIdx.y;
  const int row = tile_row[j], ts = tile_start[j], n_tok = tile_len[j];
  const int group = H / HKV;
  const long tok = (long)H * D;
  if (row >= R) {  // a padding tile: zeros for this KV head's columns
    const int w = group * D;
    for (int idx = threadIdx.x; idx < n_tok * w; idx += kWarpgroup) {
      const int i = idx / w, c = idx % w;
      out[(long)(ts + i) * tok + (long)g * w + c] = __float2bfloat16(0.f);
    }
    return;
  }
  unsigned char* sm = aligned_smem(smem);
  int* s_pos = reinterpret_cast<int*>(sm + POS_OFF);
  for (int i = threadIdx.x; i < n_tok; i += kWarpgroup) s_pos[i] = tok_pos[ts + i];
  if (threadIdx.x == 0) *reinterpret_cast<int*>(sm + NTOK_OFF) = n_tok;
  __syncthreads();
  attend_q8<1>(q + (long)ts * tok, out + (long)ts * tok, tok, BQ, group, g, kv,
               page_table + (long)row * MP, MP, kv_len[row], scale, sm);
}

// the calls this kernel takes (the wrapper routes every other one to the
// older body): head_dim 128, 64-row tiles, whole 64-key tiles in a page,
// 16-byte aligned operands
bool takes(const void* q, const void* k, const void* v, const void* ks, const void* vs, int H,
           int HKV, int D_, int PS, int BQ) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  return D_ == D && HKV > 0 && H % HKV == 0 && (H / HKV) * BQ == kRows && PS % kKeys == 0 &&
         aligned(q) && aligned(k) && aligned(v) && aligned(ks) && aligned(vs);
}

KV8 make_kv(const void* k_pages, const void* v_pages, const void* k_scales, const void* v_scales,
            int layer, int HKV, int P, int PS, int SPAD) {
  const long layer_off = (long)layer * P * PS * HKV * D;
  const long scale_off = (long)layer * P * SPAD * PS;
  return KV8{static_cast<const int8_t*>(k_pages) + layer_off,
             static_cast<const int8_t*>(v_pages) + layer_off,
             static_cast<const float*>(k_scales) + scale_off,
             static_cast<const float*>(v_scales) + scale_off, (long)HKV * D, PS, SPAD};
}

}  // namespace

// the arguments of paged_attention_int8 (paged_attention.cu); KT, the
// partials and pages_per_split are unused: this kernel takes no splits
extern "C" int paged_attention_int8_sm90(const void* q, const void* k_pages, const void* v_pages,
                                         const void* k_scales, const void* v_scales, void* out,
                                         void* part_acc, void* part_ml, const void* page_table,
                                         const void* q_offset, const void* kv_len, int layer,
                                         int B, int C, int H, int HKV, int D_, int P, int PS,
                                         int SPAD, int KT, int MP, int BQ, int splits,
                                         int pages_per_split, float scale, void* stream) {
  (void)part_acc, (void)part_ml, (void)KT, (void)pages_per_split;
  if (splits != 1 || !takes(q, k_pages, v_pages, k_scales, v_scales, H, HKV, D_, PS, BQ)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = smem_bytes(kPagedWG);
  cudaError_t err = cudaFuncSetAttribute(paged_attention_q8_sm90_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((C + kPagedWG * BQ - 1) / (kPagedWG * BQ), HKV, B);
  paged_attention_q8_sm90_kernel<<<grid, kPagedWG * kWarpgroup, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      make_kv(k_pages, v_pages, k_scales, v_scales, layer, HKV, P, PS, SPAD),
      static_cast<__nv_bfloat16*>(out), static_cast<const int*>(page_table),
      static_cast<const int*>(q_offset), static_cast<const int*>(kv_len), C, H, HKV, MP, BQ,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// the arguments of ragged_paged_attention_int8 (ragged_paged_attention.cu)
extern "C" int ragged_paged_attention_int8_sm90(
    const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
    const void* v_scales, void* out, const void* page_table, const void* tok_pos,
    const void* kv_len, const void* tile_row, const void* tile_start, const void* tile_len,
    int layer, int T, int R, int H, int HKV, int D_, int P, int PS, int SPAD, int KT, int MP,
    int NT, int BQ, float scale, void* stream) {
  (void)T, (void)KT;
  if (!takes(q, k_pages, v_pages, k_scales, v_scales, H, HKV, D_, PS, BQ)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = smem_bytes(1);
  cudaError_t err = cudaFuncSetAttribute(ragged_attention_q8_sm90_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(NT, HKV);
  ragged_attention_q8_sm90_kernel<<<grid, kWarpgroup, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      make_kv(k_pages, v_pages, k_scales, v_scales, layer, HKV, P, PS, SPAD),
      static_cast<__nv_bfloat16*>(out), static_cast<const int*>(page_table),
      static_cast<const int*>(tok_pos), static_cast<const int*>(kv_len),
      static_cast<const int*>(tile_row), static_cast<const int*>(tile_start),
      static_cast<const int*>(tile_len), R, H, HKV, MP, BQ, scale);
  return static_cast<int>(cudaGetLastError());
}
