// Paged attention (K1) for Hopper, bf16.
//
// Replaces the TPU kernel finchat_tpu/ops/paged_attention.py
// paged_flash_attention (_paged_kernel): causal GQA attention of B x C query
// tokens over the full-depth paged KV cache [L, P, page_size, Hkv*D] of one
// layer; query row i of sequence b sits at position q_offset[b] + i, and keys
// at or past kv_len[b] are masked. C = 1 is decode, C = chunk is prefill.
//
// What bounds it on the H100: the KV bytes read. A decode step reads every
// live page of every sequence once per layer (2 * kv_len * Hkv * D * 2 bytes
// per sequence) and does ~2 * H * kv_len * D * 2 FLOPs on them, far below the
// ~295 FLOP/byte the card needs before compute binds. Prefill at C = 512 is
// heavier in compute but still reads each page once per (tile, KV head).
//
// Design: one block per (query tile of up to 64/group tokens, KV head,
// sequence, split). The block reads its own page ids from page_table[b] and
// walks its logical pages in a loop, stopping at kv_len[b] and at the tile's
// last query position (pages wholly in the causal future are skipped). Each
// page's K and V slice of the head is staged in shared memory 64 keys at a
// time and serves all `group` query heads of that KV head — the GQA saving
// the TPU kernel has. Decode (C = 1) has one tile per sequence, too few
// blocks to keep the card's 132 SMs reading, so its pages are split over
// `splits` blocks of `pages_per_split` pages each (flash-decoding); a second
// small kernel merges the fp32 partials. Online softmax state stays in fp32;
// output is bf16. Full 64-row tiles (prefill chunks) run QK^T and PV on tensor
// cores with mma.sync m16n8k16 bf16; decode-sized blocks and pages that are
// not a multiple of 64 keys use plain FMA (attention_common.cuh has both
// bodies).
#include "attention_common.cuh"

namespace {

template <int D, int MAXROWS, bool TC>
__global__ void __launch_bounds__(fct::kThreads) paged_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages, __nv_bfloat16* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_ml,
    const int* __restrict__ page_table, const int* __restrict__ q_offset,
    const int* __restrict__ kv_len, int layer, int B, int C, int H, int HKV, int P,
    int PS, int KT, int MP, int BQ, int splits, int pages_per_split, float scale) {
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
  const long layer_off = (long)layer * P * PS * HKV * D;
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
    fct::attend_tile_tc(q + tok0 * tok, tok, dst, s_pos, n_tok, BQ, group, g,
                        k_pages + layer_off, v_pages + layer_off, page_table + (long)b * MP,
                        kv_len[b], PS, 0, MP, HKV, scale, smem + fct::kPosBytes);
  } else {
    fct::attend_tile<D, MAXROWS>(q + tok0 * tok, tok, dst, s_pos, n_tok, BQ, group, g,
                                 k_pages + layer_off, v_pages + layer_off,
                                 page_table + (long)b * MP, kv_len[b], PS, KT,
                                 s * pages_per_split, (s + 1) * pages_per_split, HKV, scale,
                                 smem + fct::kPosBytes);
  }
}

template <int D, int MAXROWS, bool TC>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages, void* out,
                   float* part_acc, float* part_ml, const int* page_table,
                   const int* q_offset, const int* kv_len, int layer, int B, int C, int H,
                   int HKV, int P, int PS, int KT, int MP, int BQ, int splits,
                   int pages_per_split, float scale, cudaStream_t stream) {
  const int R = (H / HKV) * BQ;
  const size_t smem = TC ? fct::smem_bytes_tc() : fct::smem_bytes(D, KT, R);
  cudaError_t err = cudaFuncSetAttribute(paged_attention_kernel<D, MAXROWS, TC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((C + BQ - 1) / BQ, HKV, B * splits);
  paged_attention_kernel<D, MAXROWS, TC><<<grid, fct::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pages),
      static_cast<const __nv_bfloat16*>(v_pages), static_cast<__nv_bfloat16*>(out),
      part_acc, part_ml, page_table, q_offset, kv_len, layer, B, C, H, HKV, P, PS, KT, MP,
      BQ, splits, pages_per_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  fct::combine_splits<<<B * C, fct::kThreads, 0, stream>>>(
      part_acc, part_ml, static_cast<__nv_bfloat16*>(out), B * C, H, D, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" int paged_attention_bf16(const void* q, const void* k_pages, const void* v_pages,
                                    void* out, void* part_acc, void* part_ml,
                                    const void* page_table, const void* q_offset,
                                    const void* kv_len, int layer, int B, int C, int H,
                                    int HKV, int D, int P, int PS, int KT, int MP, int BQ,
                                    int splits, int pages_per_split, float scale,
                                    void* stream) {
  const int* pt = static_cast<const int*>(page_table);
  const int* qo = static_cast<const int*>(q_offset);
  const int* kl = static_cast<const int*>(kv_len);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D != 128) return static_cast<int>(cudaErrorInvalidValue);  // built for head_dim 128
  const int rows = (H / HKV) * BQ;
  cudaError_t err;
  if (rows <= 16) {  // decode-sized blocks: a small accumulator
    err = launch<128, 16, false>(q, k_pages, v_pages, out, pa, pm, pt, qo, kl, layer, B, C, H,
                                 HKV, P, PS, KT, MP, BQ, splits, pages_per_split, scale, st);
  } else if (rows == fct::kTcRows && splits == 1 && PS % fct::kTcKeys == 0) {
    // full 64-row tiles on tensor cores (prefill chunks)
    err = launch<128, fct::kMaxRows, true>(q, k_pages, v_pages, out, pa, pm, pt, qo, kl, layer,
                                           B, C, H, HKV, P, PS, KT, MP, BQ, splits,
                                           pages_per_split, scale, st);
  } else {
    err = launch<128, fct::kMaxRows, false>(q, k_pages, v_pages, out, pa, pm, pt, qo, kl, layer,
                                            B, C, H, HKV, P, PS, KT, MP, BQ, splits,
                                            pages_per_split, scale, st);
  }
  return static_cast<int>(err);
}
