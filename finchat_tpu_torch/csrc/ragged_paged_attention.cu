// Ragged paged attention (K3) for Hopper, bf16.
//
// Replaces the TPU kernel finchat_tpu/ops/ragged_paged_attention.py
// ragged_flash_attention (_ragged_kernel): the paged attention of K1 over a
// packed [T, H, D] buffer whose rows are contiguous token spans — a prefill
// chunk, a 1-token decode row, ... — each with its own page-table row and
// kv_len; every token's causal bound is its own tok_pos. Padding tokens
// (tok_row == R) give zeros.
//
// What bounds it on the H100: the KV bytes read, as in K1 — every row reads
// its live pages once per (tile, KV head).
//
// Design: the wrapper (ops/ragged_paged_attention.py) cuts the packed buffer
// into tiles of up to 64/group tokens that each belong to exactly ONE row
// (tile_row, tile_start, tile_len, built with a few torch ops from tok_row,
// no host sync), so the body is K1's page loop (attention_common.cuh) with
// the row's page-table row and kv_len,
// staging 64 keys of a page at a time. The TPU kernel's 8-row alignment and
// its aligned-layout scatter/gather of q and out stay behind: a tile reads
// its tokens in place. The bounded-KV coordinate shift (kv_gap) is applied by
// the wrapper, so this body is gap-oblivious. Tiles past the last row's
// (tile_row == R) zero the padding tokens [tile_start, tile_start+tile_len)
// for their KV head's columns, so the output needs no memset.
#include "attention_common.cuh"

namespace {

template <int D, int MAXROWS, bool TC>
__global__ void __launch_bounds__(fct::kThreads) ragged_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages, __nv_bfloat16* __restrict__ out,
    const int* __restrict__ page_table, const int* __restrict__ tok_pos,
    const int* __restrict__ kv_len, const int* __restrict__ tile_row,
    const int* __restrict__ tile_start, const int* __restrict__ tile_len, int layer,
    int R, int H, int HKV, int P, int PS, int KT, int MP, int BQ, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int j = blockIdx.x, g = blockIdx.y;
  const int row = tile_row[j];
  const int ts = tile_start[j];
  const int n_tok = tile_len[j];
  const int group = H / HKV;
  const long tok = (long)H * D;
  if (row >= R) {
    const int w = group * D;
    for (int idx = threadIdx.x; idx < n_tok * w; idx += fct::kThreads) {
      const int i = idx / w, c = idx % w;
      out[(long)(ts + i) * tok + (long)g * w + c] = __float2bfloat16(0.f);
    }
    return;
  }
  int* s_pos = reinterpret_cast<int*>(smem);
  for (int i = threadIdx.x; i < n_tok; i += fct::kThreads) s_pos[i] = tok_pos[ts + i];
  __syncthreads();
  const long layer_off = (long)layer * P * PS * HKV * D;
  fct::TileOut dst;
  dst.out = out + (long)ts * tok;
  dst.part_acc = nullptr;
  dst.part_ml = nullptr;
  dst.tok_stride = tok;
  dst.H = H;
  if constexpr (TC) {
    fct::attend_tile_tc(q + (long)ts * tok, tok, dst, s_pos, n_tok, BQ, group, g,
                        k_pages + layer_off, v_pages + layer_off, page_table + (long)row * MP,
                        kv_len[row], PS, 0, MP, HKV, scale, smem + fct::kPosBytes);
  } else {
    fct::attend_tile<D, MAXROWS>(q + (long)ts * tok, tok, dst, s_pos, n_tok, BQ, group, g,
                                 k_pages + layer_off, v_pages + layer_off,
                                 page_table + (long)row * MP, kv_len[row], PS, KT, 0, MP, HKV,
                                 scale, smem + fct::kPosBytes);
  }
}

template <int D, int MAXROWS, bool TC>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages, void* out,
                   const int* page_table, const int* tok_pos, const int* kv_len,
                   const int* tile_row, const int* tile_start, const int* tile_len,
                   int layer, int R, int H, int HKV, int P, int PS, int KT, int MP, int NT,
                   int BQ, float scale, cudaStream_t stream) {
  const int rows = (H / HKV) * BQ;
  const size_t smem = TC ? fct::smem_bytes_tc() : fct::smem_bytes(D, KT, rows);
  cudaError_t err = cudaFuncSetAttribute(ragged_attention_kernel<D, MAXROWS, TC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(NT, HKV);
  ragged_attention_kernel<D, MAXROWS, TC><<<grid, fct::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pages),
      static_cast<const __nv_bfloat16*>(v_pages), static_cast<__nv_bfloat16*>(out),
      page_table, tok_pos, kv_len, tile_row, tile_start, tile_len, layer, R, H, HKV, P, PS,
      KT, MP, BQ, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ragged_paged_attention_bf16(
    const void* q, const void* k_pages, const void* v_pages, void* out,
    const void* page_table, const void* tok_pos, const void* kv_len, const void* tile_row,
    const void* tile_start, const void* tile_len, int layer, int T, int R, int H, int HKV,
    int D, int P, int PS, int KT, int MP, int NT, int BQ, float scale, void* stream) {
  (void)T;
  const int* pt = static_cast<const int*>(page_table);
  const int* tp = static_cast<const int*>(tok_pos);
  const int* kl = static_cast<const int*>(kv_len);
  const int* tr = static_cast<const int*>(tile_row);
  const int* tst = static_cast<const int*>(tile_start);
  const int* tl = static_cast<const int*>(tile_len);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D != 128) return static_cast<int>(cudaErrorInvalidValue);  // built for head_dim 128
  const int rows = (H / HKV) * BQ;
  cudaError_t err;
  if (rows <= 16) {  // small groups: a small accumulator
    err = launch<128, 16, false>(q, k_pages, v_pages, out, pt, tp, kl, tr, tst, tl, layer, R,
                                 H, HKV, P, PS, KT, MP, NT, BQ, scale, st);
  } else if (rows == fct::kTcRows && PS % fct::kTcKeys == 0) {
    // full 64-row tiles on tensor cores
    err = launch<128, fct::kMaxRows, true>(q, k_pages, v_pages, out, pt, tp, kl, tr, tst, tl,
                                           layer, R, H, HKV, P, PS, KT, MP, NT, BQ, scale, st);
  } else {
    err = launch<128, fct::kMaxRows, false>(q, k_pages, v_pages, out, pt, tp, kl, tr, tst, tl,
                                            layer, R, H, HKV, P, PS, KT, MP, NT, BQ, scale, st);
  }
  return static_cast<int>(err);
}
