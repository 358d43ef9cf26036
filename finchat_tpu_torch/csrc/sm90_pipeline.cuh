// Pipeline helpers shared by the Hopper kernels (quant_matmul_sm90.cu,
// quant_matmul_decode_sm90.cu, attention_q8_sm90.cu, attention_bf16_sm90.cu,
// attention_decode_sm90.cu): mbarrier waits that trap instead of hanging,
// the cp.async copies that complete on an mbarrier, TMA tile loads and the
// host encoding of their tensor maps, the wgmma shared-memory descriptor and
// fences, and the byte permute that turns a stored int8 (or int4) value into
// an exact float.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fct {

// ---------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// wait until the barrier's phase of this parity has completed; a phase that
// never completes traps after ~2^34 cycles (a failed launch, not a hung card)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity)) {
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// ---------------------------------------------------------------- cp.async

// 16 bytes from global to shared memory, bypassing L1
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

// one arrival on `bar` once every cp.async this thread issued so far has
// landed (the barrier's count includes this thread: no arrival of its own)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// ---------------------------------------------------------------- TMA

// a 2D box of the tensor `map` at coordinates (c0 innermost, c1) into
// shared memory at `dst`, completing its bytes on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda: reached through the runtime's
// entry-point lookup, so a library needs no link against it
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// a row-major [rows, cols] tensor read in boxes of [box_rows, box_cols]
inline bool make_map(CUtensorMap* map, CUtensorMapDataType dtype, int elem_bytes,
                     const void* ptr, uint64_t rows, uint64_t cols, uint32_t box_rows,
                     uint32_t box_cols, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * elem_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, dtype, 2, const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------- wgmma

// the generic proxy's shared-memory stores, visible to the async proxy
// (wgmma, TMA) after this fence and a barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// shared-memory matrix descriptor: K-major, 128-byte swizzle, rows of 128
// bytes in atoms of 8 rows (1024 bytes apart, 1024-byte aligned); the
// leading offset is unused
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// keeps the compiler from moving accesses of registers an asynchronous
// wgmma reads or writes across the fence
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ---------------------------------------------------------------- dequant

// byte j of u (an unsigned value v < 256) as the exact float v - bias: the
// byte under the exponent of 2^23 reads 2^23 + v
__device__ __forceinline__ float byte_as_float(uint32_t u, int j, float bias) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u + j)) - bias;
}

constexpr float kInt8Bias = 8388608.f + 128.f;  // 2^23 + the 0x80 offset
constexpr float kInt4Bias = 8388608.f + 8.f;    // 2^23 + the 8 offset

}  // namespace fct
