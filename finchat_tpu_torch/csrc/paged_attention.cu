// Paged attention for Hopper: K1 over a bf16 cache, K4 over an int8 cache.
//
// Replaces the TPU kernel finchat_tpu/ops/paged_attention.py
// paged_flash_attention (_paged_kernel) and, for the int8 cache,
// paged_flash_attention_q8 (_paged_kernel_q8): causal GQA attention of B x C
// query tokens over the full-depth paged KV cache [L, P, page_size, Hkv*D] of
// one layer; query row i of sequence b sits at position q_offset[b] + i, and
// keys at or past kv_len[b] are masked. C = 1 is decode, C = chunk is
// prefill. The int8 cache carries per-token-per-head fp32 scales
// [L, P, spad, page_size] beside its pages.
//
// What bounds it on the H100: the KV bytes read. A decode step reads every
// live page of every sequence once per layer (2 * kv_len * Hkv * D elements
// per sequence: 2 bytes each in bf16, 1 byte plus a 4-byte scale per head row
// in int8) and does ~2 * H * kv_len * D * 2 FLOPs on them, far below the ~295
// FLOP/byte the card needs before compute binds. Prefill at C = 512 is
// heavier in compute but still reads each page once per (tile, KV head).
//
// Design: one block per (query tile of up to 64/group tokens, KV head,
// sequence, split). The block reads its own page ids from page_table[b] and
// walks its logical pages in a loop, stopping at kv_len[b] and at the tile's
// last query position (pages wholly in the causal future are skipped). Each
// page's K and V slice of the head is staged in shared memory as bf16 64
// keys at a time — the int8 loader dequantizes as it stages
// (attention_common.cuh), so both caches run one body — and serves all
// `group` query heads of that KV head, the GQA saving the TPU kernel has.
// Decode (C = 1) has one tile per sequence, too few blocks to keep the card's
// 132 SMs reading, so its pages are split over `splits` blocks of
// `pages_per_split` pages each (flash-decoding); a second small kernel merges
// the fp32 partials. Online softmax state stays in fp32; output is bf16. Full
// 64-row tiles (prefill chunks) run QK^T and PV on tensor cores with mma.sync
// m16n8k16 bf16; decode-sized blocks and pages that are not a multiple of 64
// keys use plain FMA.
#include "attention_common.cuh"

namespace {

template <int D, int MAXROWS, bool TC, class KV>
__global__ void __launch_bounds__(fct::kThreads) paged_attention_kernel(
    const __nv_bfloat16* __restrict__ q, KV kv, __nv_bfloat16* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_ml,
    const int* __restrict__ page_table, const int* __restrict__ q_offset,
    const int* __restrict__ kv_len, int B, int C, int H, int HKV, int PS, int KT, int MP,
    int BQ, int splits, int pages_per_split, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int qt = blockIdx.x, g = blockIdx.y;
  const int b = blockIdx.z / splits, s = blockIdx.z % splits;
  const int group = H / HKV;
  const int c0 = qt * BQ;
  const int n_tok = min(BQ, C - c0);
  int* s_pos = reinterpret_cast<int*>(smem);
  const int qoff = q_offset[b];
  for (int i = threadIdx.x; i < BQ; i += fct::kThreads) s_pos[i] = qoff + c0 + i;
  __syncthreads();
  const long tok = (long)H * D;
  const long tok0 = (long)b * C + c0;
  fct::TileOut dst;
  dst.tok_stride = tok;
  dst.H = H;
  if (splits == 1) {
    dst.out = out + tok0 * tok;
    dst.part_acc = nullptr;
    dst.part_ml = nullptr;
  } else {
    dst.out = nullptr;
    dst.part_acc = part_acc + ((long)s * B * C + tok0) * tok;
    dst.part_ml = part_ml + ((long)s * B * C + tok0) * H * 2;
  }
  if constexpr (TC) {
    fct::attend_tile_tc(q + tok0 * tok, tok, dst, s_pos, n_tok, BQ, group, g, kv,
                        page_table + (long)b * MP, kv_len[b], PS, 0, MP, scale,
                        smem + fct::kPosBytes);
  } else {
    fct::attend_tile<D, MAXROWS>(q + tok0 * tok, tok, dst, s_pos, n_tok, BQ, group, g, kv,
                                 page_table + (long)b * MP, kv_len[b], PS, KT,
                                 s * pages_per_split, (s + 1) * pages_per_split, scale,
                                 smem + fct::kPosBytes);
  }
}

struct Args {
  const void* q;
  void* out;
  float* part_acc;
  float* part_ml;
  const int* page_table;
  const int* q_offset;
  const int* kv_len;
  int B, C, H, HKV, PS, KT, MP, BQ, splits, pages_per_split;
  float scale;
  cudaStream_t stream;
};

template <int D, int MAXROWS, bool TC, class KV>
cudaError_t launch(const Args& a, const KV& kv) {
  const int R = (a.H / a.HKV) * a.BQ;
  const size_t smem = TC ? fct::smem_bytes_tc() : fct::smem_bytes(D, a.KT, R);
  cudaError_t err = cudaFuncSetAttribute(paged_attention_kernel<D, MAXROWS, TC, KV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.C + a.BQ - 1) / a.BQ, a.HKV, a.B * a.splits);
  paged_attention_kernel<D, MAXROWS, TC, KV><<<grid, fct::kThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), kv, static_cast<__nv_bfloat16*>(a.out),
      a.part_acc, a.part_ml, a.page_table, a.q_offset, a.kv_len, a.B, a.C, a.H, a.HKV, a.PS,
      a.KT, a.MP, a.BQ, a.splits, a.pages_per_split, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  fct::combine_splits<<<a.B * a.C, fct::kThreads, 0, a.stream>>>(
      a.part_acc, a.part_ml, static_cast<__nv_bfloat16*>(a.out), a.B * a.C, a.H, D, a.splits);
  return cudaGetLastError();
}

// pick the block body: FMA for decode-sized blocks and pages that are not a
// multiple of 64 keys, tensor cores for full 64-row tiles
template <class KV>
int dispatch(const Args& a, const KV& kv) {
  const int rows = (a.H / a.HKV) * a.BQ;
  cudaError_t err;
  if (rows <= 16) {  // decode-sized blocks: a small accumulator
    err = launch<128, 16, false>(a, kv);
  } else if (rows == fct::kTcRows && a.splits == 1 && a.PS % fct::kTcKeys == 0) {
    err = launch<128, fct::kMaxRows, true>(a, kv);  // prefill chunks
  } else {
    err = launch<128, fct::kMaxRows, false>(a, kv);
  }
  return static_cast<int>(err);
}

Args make_args(const void* q, void* out, void* part_acc, void* part_ml, const void* page_table,
               const void* q_offset, const void* kv_len, int B, int C, int H, int HKV, int PS,
               int KT, int MP, int BQ, int splits, int pages_per_split, float scale,
               void* stream) {
  return Args{q, out, static_cast<float*>(part_acc), static_cast<float*>(part_ml),
              static_cast<const int*>(page_table), static_cast<const int*>(q_offset),
              static_cast<const int*>(kv_len), B, C, H, HKV, PS, KT, MP, BQ, splits,
              pages_per_split, scale, static_cast<cudaStream_t>(stream)};
}

}  // namespace

extern "C" int paged_attention_bf16(const void* q, const void* k_pages, const void* v_pages,
                                    void* out, void* part_acc, void* part_ml,
                                    const void* page_table, const void* q_offset,
                                    const void* kv_len, int layer, int B, int C, int H,
                                    int HKV, int D, int P, int PS, int KT, int MP, int BQ,
                                    int splits, int pages_per_split, float scale,
                                    void* stream) {
  if (D != 128) return static_cast<int>(cudaErrorInvalidValue);  // built for head_dim 128
  const long layer_off = (long)layer * P * PS * HKV * D;
  const fct::KVBf16 kv{static_cast<const __nv_bfloat16*>(k_pages) + layer_off,
                       static_cast<const __nv_bfloat16*>(v_pages) + layer_off,
                       (long)HKV * D, D, PS};
  return dispatch(make_args(q, out, part_acc, part_ml, page_table, q_offset, kv_len, B, C, H,
                            HKV, PS, KT, MP, BQ, splits, pages_per_split, scale, stream),
                  kv);
}

extern "C" int paged_attention_int8(const void* q, const void* k_pages, const void* v_pages,
                                    const void* k_scales, const void* v_scales, void* out,
                                    void* part_acc, void* part_ml, const void* page_table,
                                    const void* q_offset, const void* kv_len, int layer, int B,
                                    int C, int H, int HKV, int D, int P, int PS, int SPAD,
                                    int KT, int MP, int BQ, int splits, int pages_per_split,
                                    float scale, void* stream) {
  if (D != 128) return static_cast<int>(cudaErrorInvalidValue);  // built for head_dim 128
  const long layer_off = (long)layer * P * PS * HKV * D;
  const long scale_off = (long)layer * P * SPAD * PS;
  const fct::KVInt8 kv{static_cast<const int8_t*>(k_pages) + layer_off,
                       static_cast<const int8_t*>(v_pages) + layer_off,
                       static_cast<const float*>(k_scales) + scale_off,
                       static_cast<const float*>(v_scales) + scale_off,
                       (long)HKV * D, D, PS, SPAD};
  return dispatch(make_args(q, out, part_acc, part_ml, page_table, q_offset, kv_len, B, C, H,
                            HKV, PS, KT, MP, BQ, splits, pages_per_split, scale, stream),
                  kv);
}
