// Decode KV append (K2) for Hopper, bf16.
//
// Replaces the TPU kernel finchat_tpu/ops/kv_append.py paged_kv_append
// (_append_kernel): writes each sequence's new K row and V row of one layer
// at k_pages[layer, page_table[b, pos // page_size], pos % page_size, :], in
// place; a lane with n_valid == 0 writes the trash page 0 instead.
//
// What bounds it on the H100: bytes — it reads 2 * Hkv * D bf16 per sequence
// and writes the same, a few hundred KB per layer at B = 64; it is launch
// latency, not bandwidth, that its time shows.
//
// Design: one block per sequence; the block copies its 16-byte chunks of the
// fused k ++ v row straight into the one token row of its page. The TPU
// kernel's whole-page read-modify-write (a Mosaic DMA alignment constraint)
// stays behind: on the card a row write is a plain store, so each launch
// moves one row per sequence, not one page. Bit-exact with the plain
// version. The page-table read is guarded exactly as the TPU kernel's: an
// invalid lane reads no table column (its pos may lie past the row).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void kv_append_kernel(const uint4* __restrict__ kv_new, uint4* __restrict__ k_pages,
                                 uint4* __restrict__ v_pages, const int* __restrict__ page_table,
                                 const int* __restrict__ pos, const int* __restrict__ n_valid,
                                 int layer, int P, int PS, int HD8, int MP) {
  const int b = blockIdx.x;
  const int p = pos[b];
  const bool valid = n_valid[b] > 0;
  const long phys = valid ? page_table[(long)b * MP + p / PS] : 0;
  const long row = (((long)layer * P + phys) * PS + (p % PS)) * HD8;
  const uint4* src = kv_new + (long)b * 2 * HD8;
  for (int c = threadIdx.x; c < HD8; c += blockDim.x) {
    k_pages[row + c] = src[c];
    v_pages[row + c] = src[HD8 + c];
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
