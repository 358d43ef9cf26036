// The KV-row writer for Hopper: every cache write of a serve — decode rows,
// prefill chunks, ragged rounds — as one launch a layer, into a bf16 cache
// (K2) or, quantizing in registers, into an int8 cache with its scale
// planes (K5).
//
// Replaces the TPU kernel finchat_tpu/ops/kv_append.py _append_kernel
// (paged_kv_append) and its int8 twin _append_kernel_q8 (paged_kv_append_q8),
// and also the port's torch scatter for prefill chunks and ragged rounds
// (engine/kv_cache.py scatter_kv_chunk, scatter_kv_chunk_q8). The JAX
// kernels take a chunk too: under inplace_append a C-token chunk runs C
// appends, token i valid iff i < n_valid; one launch over the chunk's B * C
// tokens writes what those C launches write, and the same bytes as the
// scatter.
//
// What it computes. Token t's K row k[t, :] and V row v[t, :] (bf16, Hkv * hd
// values, each tensor with its own row stride, read where the projection
// and rope left them) go to row rows[t] of the layer's pages, rows[t] =
// phys * page_size + offset from the step's plan (ops/kv_append.plan_kv_rows:
// a padding lane's row lies in the trash page 0). The int8 entry quantizes
// each head row on its own — scale = (amax > 0 ? amax : 1) / 127 as a true
// division, q = clip(rint(x / scale), -127, 127) rounding half to even, the
// arithmetic of engine/kv_cache.quantize_kv_rows — and writes the scale at
// [layer, phys, head, offset] of its plane. No fast math: the division and
// rint are IEEE, so both entries are bit-exact against their plain versions
// (only where several padding lanes hit one row of the trash page does the
// last writer vary, as in the scatter; nothing reads that page).
//
// What bounds it on the H100: bytes, and below a few hundred tokens the
// launch. Per token it reads 2 * HD bf16 and writes 2 * HD bf16 (bf16) or
// 2 * HD int8 and 2 * Hkv fp32 scales (int8): 8 KB or 6.1 KB at Llama-3-8B,
// 16.8 MB or 12.6 MB for a 2,048-token chunk (~5.0 or ~3.8 us at 3.35
// TB/s), 0.5 MB or 0.4 MB for a 64-slot decode step, where the ~2-3 us of a
// launch is the floor.
//
// Design. The work is a scatter of rows with no reuse, so no TMA and no
// wgmma: what the card needs is many 16-byte accesses in flight, neighbouring
// threads on neighbouring addresses, and nothing written but the rows.
// - bf16: one block a token; thread c copies 16-byte chunk c of the K row
//   (c < HD / 8) or of the V row, so 256 threads move a Llama-3 token.
// - int8: a head row goes to a group of 16 lanes (hd <= 128) or a whole warp
//   (hd <= 256), each lane loading 8 values as one 16-byte load; the head's
//   amax comes from shuffles inside the group, the lane divides and rounds
//   its 8 values and stores them as one 64-bit store, the group's first
//   lane writes the scale. The fp32 temporaries the torch chain passes
//   through device memory ([tokens, Hkv * hd] copies, abs, amax, quotients)
//   stay in registers.
// - The launch count: the plan (rows) is built once a step, so a layer's
//   write is this one launch with two data pointers that change — against
//   ~10 (bf16) or ~25 (int8) launches a layer of the torch scatter, and
//   a torch.cat before the older append.
// Offsets are 64-bit: layer * P * PS * HD passes 2^31 at 512 pages.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__global__ void kv_write_bf16_kernel(const uint4* __restrict__ k, const uint4* __restrict__ v,
                                     const int* __restrict__ rows, uint4* __restrict__ k_pages,
                                     uint4* __restrict__ v_pages, long layer_rows, int HD8,
                                     long k_stride8, long v_stride8) {
  const int t = blockIdx.x;
  const long dst = (layer_rows + rows[t]) * HD8;
  for (int c = threadIdx.x; c < 2 * HD8; c += blockDim.x) {
    if (c < HD8) {
      k_pages[dst + c] = k[t * k_stride8 + c];
    } else {
      v_pages[dst + c - HD8] = v[t * v_stride8 + c - HD8];
    }
  }
}

// GROUP lanes (16 or 32) a head row of D <= 8 * GROUP values; lanes past D / 8
// load nothing and reduce zeros
template <int GROUP>
__global__ void kv_write_int8_kernel(const __nv_bfloat16* __restrict__ k,
                                     const __nv_bfloat16* __restrict__ v,
                                     const int* __restrict__ rows, int8_t* __restrict__ k_pages,
                                     int8_t* __restrict__ v_pages, float* __restrict__ k_scales,
                                     float* __restrict__ v_scales, int layer, int N, int P,
                                     int PS, int HKV, int D, int SPAD, long k_stride,
                                     long v_stride) {
  const int lane = threadIdx.x % GROUP;
  const long g = (long)blockIdx.x * (blockDim.x / GROUP) + threadIdx.x / GROUP;
  // (token, K or V, head): every lane of a warp takes part in the shuffles,
  // so a group past the last row only skips its loads and stores
  const bool live = g < (long)N * 2 * HKV;
  const int t = live ? (int)(g / (2 * HKV)) : 0;
  const int hr = (int)(g % (2 * HKV));
  const bool is_v = hr >= HKV;
  const int h = is_v ? hr - HKV : hr;
  const bool mine = live && 8 * lane < D;
  float x[8];
  float amax = 0.f;
  if (mine) {
    const __nv_bfloat16* src = (is_v ? v + t * v_stride : k + t * k_stride) + (long)h * D;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + 8 * lane);
    const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      x[j] = __bfloat162float(xb[j]);
      amax = fmaxf(amax, fabsf(x[j]));
    }
  }
#pragma unroll
  for (int o = GROUP / 2; o > 0; o >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  }
  if (!mine) return;
  const float scale = __fdiv_rn(amax > 0.f ? amax : 1.f, 127.f);
  uint32_t packed[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float r = fminf(fmaxf(rintf(__fdiv_rn(x[j], scale)), -127.f), 127.f);
    packed[j / 4] |= (uint32_t)(uint8_t)(int8_t)r << (8 * (j % 4));
  }
  const int row = rows[t];
  const long HD = (long)HKV * D;
  int8_t* dst = (is_v ? v_pages : k_pages) + ((long)layer * P * PS + row) * HD + (long)h * D;
  *reinterpret_cast<uint2*>(dst + 8 * lane) = make_uint2(packed[0], packed[1]);
  if (lane == 0) {
    const long phys = row / PS, off = row % PS;
    (is_v ? v_scales : k_scales)[(((long)layer * P + phys) * SPAD + h) * PS + off] = scale;
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// k, v bf16 [N, HD] with row strides k_stride, v_stride (elements); rows
// int32 [N]; k_pages, v_pages bf16 [L, P, PS, HD], written in place
extern "C" int kv_write_bf16_sm90(const void* k, const void* v, const void* rows, void* k_pages,
                                  void* v_pages, int layer, int N, int P, int PS, int HD,
                                  int k_stride, int v_stride, void* stream) {
  const bool ok = N >= 1 && HD >= 8 && HD % 8 == 0 && k_stride % 8 == 0 && v_stride % 8 == 0 &&
                  k_stride >= HD && v_stride >= HD && aligned16(k) && aligned16(v) &&
                  aligned16(k_pages) && aligned16(v_pages) && layer >= 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int HD8 = HD / 8;  // 16-byte chunks of a row
  const int threads = 2 * HD8 < 32 ? 32 : (2 * HD8 > 256 ? 256 : 2 * HD8);
  kv_write_bf16_kernel<<<N, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(k), static_cast<const uint4*>(v), static_cast<const int*>(rows),
      static_cast<uint4*>(k_pages), static_cast<uint4*>(v_pages), (long)layer * P * PS, HD8,
      k_stride / 8, v_stride / 8);
  return static_cast<int>(cudaGetLastError());
}

// k, v bf16 [N, HKV * D] with row strides; rows int32 [N]; k_pages, v_pages
// int8 [L, P, PS, HKV * D]; k_scales, v_scales fp32 [L, P, SPAD, PS]
extern "C" int kv_write_int8_sm90(const void* k, const void* v, const void* rows, void* k_pages,
                                  void* v_pages, void* k_scales, void* v_scales, int layer, int N,
                                  int P, int PS, int HKV, int D, int SPAD, int k_stride,
                                  int v_stride, void* stream) {
  const int HD = HKV * D;
  const bool ok = N >= 1 && HKV >= 1 && HKV <= SPAD && D >= 8 && D % 8 == 0 && D <= 256 &&
                  k_stride % 8 == 0 && v_stride % 8 == 0 && k_stride >= HD && v_stride >= HD &&
                  aligned16(k) && aligned16(v) && aligned16(k_pages) && aligned16(v_pages) &&
                  layer >= 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const long groups = (long)N * 2 * HKV;  // head rows
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* r = static_cast<const int*>(rows);
  auto* kp = static_cast<int8_t*>(k_pages);
  auto* vp = static_cast<int8_t*>(v_pages);
  auto* ks = static_cast<float*>(k_scales);
  auto* vs = static_cast<float*>(v_scales);
  constexpr int kThreads = 256;
  if (D <= 128) {
    const unsigned blocks = (unsigned)((groups + kThreads / 16 - 1) / (kThreads / 16));
    kv_write_int8_kernel<16><<<blocks, kThreads, 0, st>>>(kb, vb, r, kp, vp, ks, vs, layer, N, P,
                                                          PS, HKV, D, SPAD, k_stride, v_stride);
  } else {
    const unsigned blocks = (unsigned)((groups + kThreads / 32 - 1) / (kThreads / 32));
    kv_write_int8_kernel<32><<<blocks, kThreads, 0, st>>>(kb, vb, r, kp, vp, ks, vs, layer, N, P,
                                                          PS, HKV, D, SPAD, k_stride, v_stride);
  }
  return static_cast<int>(cudaGetLastError());
}
