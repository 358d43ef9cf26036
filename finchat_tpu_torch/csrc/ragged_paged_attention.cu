// Ragged paged attention for Hopper: K3 over a bf16 cache, K6 over an int8
// cache.
//
// Replaces the TPU kernel finchat_tpu/ops/ragged_paged_attention.py
// ragged_flash_attention (_ragged_kernel) and, for the int8 cache,
// ragged_flash_attention_q8 (_ragged_kernel_q8): the paged attention of K1
// over a packed [T, H, D] buffer whose rows are contiguous token spans — a
// prefill chunk, a 1-token decode row, ... — each with its own page-table row
// and kv_len; every token's causal bound is its own tok_pos. Padding tokens
// (tok_row == R) give zeros.
//
// What bounds it on the H100: the KV bytes read, as in K1 — every row reads
// its live pages once per (tile, KV head); the int8 cache reads half the
// bytes plus one fp32 scale per token and head.
//
// Design: the wrapper (ops/ragged_paged_attention.py) cuts the packed buffer
// into tiles of up to 64/group tokens that each belong to exactly ONE row
// (tile_row, tile_start, tile_len, built with a few torch ops from tok_row,
// no host sync), so the body is K1's page loop (attention_common.cuh) with
// the row's page-table row and kv_len, staging 64 keys of a page at a time
// (dequantized to bf16 as they are staged, for the int8 cache). The TPU
// kernel's 8-row alignment and its aligned-layout scatter/gather of q and out
// stay behind: a tile reads its tokens in place. The bounded-KV coordinate
// shift (kv_gap) is applied by the wrapper, so this body is gap-oblivious.
// Tiles past the last row's (tile_row == R) zero the padding tokens
// [tile_start, tile_start+tile_len) for their KV head's columns, so the
// output needs no memset.
#include "attention_common.cuh"

namespace {

template <int D, int MAXROWS, bool TC, class KV>
__global__ void __launch_bounds__(fct::kThreads) ragged_attention_kernel(
    const __nv_bfloat16* __restrict__ q, KV kv, __nv_bfloat16* __restrict__ out,
    const int* __restrict__ page_table, const int* __restrict__ tok_pos,
    const int* __restrict__ kv_len, const int* __restrict__ tile_row,
    const int* __restrict__ tile_start, const int* __restrict__ tile_len, int R, int H,
    int HKV, int PS, int KT, int MP, int BQ, float scale) {
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
  fct::TileOut dst;
  dst.out = out + (long)ts * tok;
  dst.part_acc = nullptr;
  dst.part_ml = nullptr;
  dst.tok_stride = tok;
  dst.H = H;
  if constexpr (TC) {
    fct::attend_tile_tc(q + (long)ts * tok, tok, dst, s_pos, n_tok, BQ, group, g, kv,
                        page_table + (long)row * MP, kv_len[row], PS, 0, MP, scale,
                        smem + fct::kPosBytes);
  } else {
    fct::attend_tile<D, MAXROWS>(q + (long)ts * tok, tok, dst, s_pos, n_tok, BQ, group, g, kv,
                                 page_table + (long)row * MP, kv_len[row], PS, KT, 0, MP,
                                 scale, smem + fct::kPosBytes);
  }
}

struct Args {
  const void* q;
  void* out;
  const int* page_table;
  const int* tok_pos;
  const int* kv_len;
  const int* tile_row;
  const int* tile_start;
  const int* tile_len;
  int R, H, HKV, PS, KT, MP, NT, BQ;
  float scale;
  cudaStream_t stream;
};

template <int D, int MAXROWS, bool TC, class KV>
cudaError_t launch(const Args& a, const KV& kv) {
  const int rows = (a.H / a.HKV) * a.BQ;
  const size_t smem = TC ? fct::smem_bytes_tc() : fct::smem_bytes(D, a.KT, rows);
  cudaError_t err = cudaFuncSetAttribute(ragged_attention_kernel<D, MAXROWS, TC, KV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.NT, a.HKV);
  ragged_attention_kernel<D, MAXROWS, TC, KV><<<grid, fct::kThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), kv, static_cast<__nv_bfloat16*>(a.out),
      a.page_table, a.tok_pos, a.kv_len, a.tile_row, a.tile_start, a.tile_len, a.R, a.H, a.HKV,
      a.PS, a.KT, a.MP, a.BQ, a.scale);
  return cudaGetLastError();
}

template <class KV>
int dispatch(const Args& a, const KV& kv) {
  const int rows = (a.H / a.HKV) * a.BQ;
  cudaError_t err;
  if (rows <= 16) {  // small groups: a small accumulator
    err = launch<128, 16, false>(a, kv);
  } else if (rows == fct::kTcRows && a.PS % fct::kTcKeys == 0) {
    err = launch<128, fct::kMaxRows, true>(a, kv);  // full 64-row tiles on tensor cores
  } else {
    err = launch<128, fct::kMaxRows, false>(a, kv);
  }
  return static_cast<int>(err);
}

Args make_args(const void* q, void* out, const void* page_table, const void* tok_pos,
               const void* kv_len, const void* tile_row, const void* tile_start,
               const void* tile_len, int R, int H, int HKV, int PS, int KT, int MP, int NT,
               int BQ, float scale, void* stream) {
  return Args{q, out, static_cast<const int*>(page_table), static_cast<const int*>(tok_pos),
              static_cast<const int*>(kv_len), static_cast<const int*>(tile_row),
              static_cast<const int*>(tile_start), static_cast<const int*>(tile_len), R, H,
              HKV, PS, KT, MP, NT, BQ, scale, static_cast<cudaStream_t>(stream)};
}

}  // namespace

extern "C" int ragged_paged_attention_bf16(
    const void* q, const void* k_pages, const void* v_pages, void* out,
    const void* page_table, const void* tok_pos, const void* kv_len, const void* tile_row,
    const void* tile_start, const void* tile_len, int layer, int T, int R, int H, int HKV,
    int D, int P, int PS, int KT, int MP, int NT, int BQ, float scale, void* stream) {
  (void)T;
  if (D != 128) return static_cast<int>(cudaErrorInvalidValue);  // built for head_dim 128
  const long layer_off = (long)layer * P * PS * HKV * D;
  const fct::KVBf16 kv{static_cast<const __nv_bfloat16*>(k_pages) + layer_off,
                       static_cast<const __nv_bfloat16*>(v_pages) + layer_off,
                       (long)HKV * D, D, PS};
  return dispatch(make_args(q, out, page_table, tok_pos, kv_len, tile_row, tile_start,
                            tile_len, R, H, HKV, PS, KT, MP, NT, BQ, scale, stream),
                  kv);
}

extern "C" int ragged_paged_attention_int8(
    const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
    const void* v_scales, void* out, const void* page_table, const void* tok_pos,
    const void* kv_len, const void* tile_row, const void* tile_start, const void* tile_len,
    int layer, int T, int R, int H, int HKV, int D, int P, int PS, int SPAD, int KT, int MP,
    int NT, int BQ, float scale, void* stream) {
  (void)T;
  if (D != 128) return static_cast<int>(cudaErrorInvalidValue);  // built for head_dim 128
  const long layer_off = (long)layer * P * PS * HKV * D;
  const long scale_off = (long)layer * P * SPAD * PS;
  const fct::KVInt8 kv{static_cast<const int8_t*>(k_pages) + layer_off,
                       static_cast<const int8_t*>(v_pages) + layer_off,
                       static_cast<const float*>(k_scales) + scale_off,
                       static_cast<const float*>(v_scales) + scale_off,
                       (long)HKV * D, D, PS, SPAD};
  return dispatch(make_args(q, out, page_table, tok_pos, kv_len, tile_row, tile_start,
                            tile_len, R, H, HKV, PS, KT, MP, NT, BQ, scale, stream),
                  kv);
}
