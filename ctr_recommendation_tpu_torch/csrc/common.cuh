// Device helpers shared by the port's hand-written Hopper kernels.
//
// T is the compute dtype of a kernel: float or __nv_bfloat16. Every rounding
// point of the reference (a cast to the compute dtype) is an explicit
// rnd<T>() here, so the kernels round exactly where the JAX kernels and the
// plain PyTorch versions do.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace ctr {

constexpr int kThreads = 256;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and widened back: the value a cast to the compute dtype keeps
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}

// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3"): the counter c under the key k, ten rounds, the key bumped between them.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// Whether dropout keeps element (token, col) of site (layer, branch): word
// col % 4 of Philox4x32-10 at counter (token, col / 4, 2 layer + branch, 0)
// under key (seed's low, high 32 bits); u = (word >> 8) 2^-24 (the top 24
// bits) and the element is kept iff u >= rate. The mask depends on nothing
// else, so any tiling of the batch draws it alike.
// The four words of column group col / 4 (dropout_keep's counter), and
// whether a word keeps its element.
__device__ __forceinline__ uint4 dropout_words(uint64_t seed, uint32_t token, int col, int layer,
                                               int branch) {
  return philox4x32_10(
      make_uint4(token, static_cast<uint32_t>(col) >> 2, static_cast<uint32_t>(2 * layer + branch),
                 0u),
      make_uint2(static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32)));
}
__device__ __forceinline__ uint32_t word_of(uint4 w, int j) {
  return j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w;
}
__device__ __forceinline__ bool word_keeps(uint32_t word, float rate) {
  return static_cast<float>(word >> 8) * 0x1p-24f >= rate;
}

__device__ __forceinline__ bool dropout_keep(uint64_t seed, uint32_t token, int col, int layer,
                                             int branch, float rate) {
  return word_keeps(word_of(dropout_words(seed, token, col, layer, branch), col & 3), rate);
}

__device__ __forceinline__ void load8(float* dst, const float* src) {
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(dst);
  d[0] = s[0];
  d[1] = s[1];
}

__device__ __forceinline__ void load8(float* dst, const __nv_bfloat16* src) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
  float4* d = reinterpret_cast<float4*>(dst);
  d[0] = make_float4(__bfloat162float(h[0]), __bfloat162float(h[1]),
                     __bfloat162float(h[2]), __bfloat162float(h[3]));
  d[1] = make_float4(__bfloat162float(h[4]), __bfloat162float(h[5]),
                     __bfloat162float(h[6]), __bfloat162float(h[7]));
}

}  // namespace ctr
