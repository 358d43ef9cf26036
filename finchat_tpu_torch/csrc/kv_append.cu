// Decode KV append for Hopper: K2 into a bf16 cache, K5 (quantizing) into an
// int8 cache.
//
// Replaces the TPU kernel finchat_tpu/ops/kv_append.py paged_kv_append
// (_append_kernel) and, for the int8 cache, paged_kv_append_q8
// (_append_kernel_q8): writes each sequence's new K row and V row of one layer
// at k_pages[layer, page_table[b, pos // page_size], pos % page_size, :], in
// place; a lane with n_valid == 0 writes the trash page 0 instead. The int8
// variant quantizes the row per KV head first — scale = (amax > 0 ? amax : 1)
// / 127 as a true division, q = clip(rint(x / scale), -127, 127) rounding half
// to even, the quantize_kv_rows arithmetic — and writes the head's scale into
// its plane k_scales[layer, phys, head, pos % page_size].
//
// What bounds it on the H100: bytes — it reads 2 * Hkv * D bf16 per sequence
// and writes the same (one byte each, plus 2 * Hkv scales, for int8), a few
// hundred KB per layer at B = 64; it is launch latency, not bandwidth, that
// its time shows.
//
// Design: one block per sequence. bf16: the block copies its 16-byte chunks
// of the fused k ++ v row straight into the one token row of its page. int8:
// one warp per (K or V, head) row reduces amax with shuffles, divides, rounds
// and writes the row's bytes and its scale. The TPU kernels' whole-page
// read-modify-write (a Mosaic DMA alignment constraint) stays behind: on the
// card a row write is a plain store, so each launch moves one row per
// sequence, not one page. Bit-exact with the plain versions (no fast-math:
// the division and rint are IEEE). The page-table read is guarded exactly as
// the TPU kernel's: an invalid lane reads no table column (its pos may lie
// past the row).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ long page_row(const int* page_table, const int* pos,
                                         const int* n_valid, int b, int MP, int PS, long* phys) {
  const int p = pos[b];
  const bool valid = n_valid[b] > 0;
  *phys = valid ? page_table[(long)b * MP + p / PS] : 0;
  return p % PS;
}

__global__ void kv_append_kernel(const uint4* __restrict__ kv_new, uint4* __restrict__ k_pages,
                                 uint4* __restrict__ v_pages, const int* __restrict__ page_table,
                                 const int* __restrict__ pos, const int* __restrict__ n_valid,
                                 int layer, int P, int PS, int HD8, int MP) {
  const int b = blockIdx.x;
  long phys;
  const long off = page_row(page_table, pos, n_valid, b, MP, PS, &phys);
  const long row = (((long)layer * P + phys) * PS + off) * HD8;
  const uint4* src = kv_new + (long)b * 2 * HD8;
  for (int c = threadIdx.x; c < HD8; c += blockDim.x) {
    k_pages[row + c] = src[c];
    v_pages[row + c] = src[HD8 + c];
  }
}

__global__ void kv_append_q8_kernel(const __nv_bfloat16* __restrict__ kv_new,
                                    int8_t* __restrict__ k_pages, int8_t* __restrict__ v_pages,
                                    float* __restrict__ k_scales, float* __restrict__ v_scales,
                                    const int* __restrict__ page_table,
                                    const int* __restrict__ pos, const int* __restrict__ n_valid,
                                    int layer, int P, int PS, int HKV, int D, int SPAD, int MP) {
  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  long phys;
  const long off = page_row(page_table, pos, n_valid, b, MP, PS, &phys);
  const long HD = (long)HKV * D;
  const long row = (((long)layer * P + phys) * PS + off) * HD;
  const long srow = (((long)layer * P + phys) * SPAD) * PS + off;  // + head * PS
  // head row hr: K heads 0..HKV-1, then V heads
  for (int hr = warp; hr < 2 * HKV; hr += n_warps) {
    const int is_v = hr >= HKV;
    const int h = is_v ? hr - HKV : hr;
    const __nv_bfloat16* x = kv_new + (long)b * 2 * HD + (is_v ? HD : 0) + (long)h * D;
    float amax = 0.f;
    for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(__bfloat162float(x[d])));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float scale = __fdiv_rn(amax > 0.f ? amax : 1.f, 127.f);
    int8_t* dst = (is_v ? v_pages : k_pages) + row + (long)h * D;
    for (int d = lane; d < D; d += 32) {
      const float r = rintf(__fdiv_rn(__bfloat162float(x[d]), scale));
      dst[d] = static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
    }
    if (lane == 0) (is_v ? v_scales : k_scales)[srow + (long)h * PS] = scale;
  }
}

}  // namespace

extern "C" int kv_append_bf16(const void* kv_new, void* k_pages, void* v_pages,
                              const void* page_table, const void* pos, const void* n_valid,
                              int layer, int B, int P, int PS, int HD, int MP, void* stream) {
  const int HD8 = HD / 8;  // 16-byte chunks of bf16
  const int threads = HD8 < 128 ? (HD8 < 32 ? 32 : HD8) : 128;
  kv_append_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(kv_new), static_cast<uint4*>(k_pages),
      static_cast<uint4*>(v_pages), static_cast<const int*>(page_table),
      static_cast<const int*>(pos), static_cast<const int*>(n_valid), layer, P, PS, HD8, MP);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kv_append_int8(const void* kv_new, void* k_pages, void* v_pages, void* k_scales,
                              void* v_scales, const void* page_table, const void* pos,
                              const void* n_valid, int layer, int B, int P, int PS, int HKV,
                              int D, int SPAD, int MP, void* stream) {
  const int warps = 2 * HKV < 16 ? 2 * HKV : 16;  // one warp per (K or V, head) row
  kv_append_q8_kernel<<<B, 32 * warps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(kv_new), static_cast<int8_t*>(k_pages),
      static_cast<int8_t*>(v_pages), static_cast<float*>(k_scales), static_cast<float*>(v_scales),
      static_cast<const int*>(page_table), static_cast<const int*>(pos),
      static_cast<const int*>(n_valid), layer, P, PS, HKV, D, SPAD, MP);
  return static_cast<int>(cudaGetLastError());
}
