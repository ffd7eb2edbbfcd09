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
constexpr size_t kMaxSmem = 232448;  // 227 KB: the most one block may use

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

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
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

// n contiguous elements of T (global, 16-byte aligned, n % 8 == 0) into
// shared memory as float.
template <typename T>
__device__ __forceinline__ void load_block_f32(float* dst, const T* src, int n) {
  for (int i = threadIdx.x * 8; i < n; i += blockDim.x * 8) load8(dst + i, src + i);
}

// Rows [row0, row0 + rows) of a (B, row_elems) matrix into shared memory in
// 16-byte pieces; rows at or past B are zero-filled (the ragged last tile is
// masked, never read). row_elems * sizeof(T) must be a multiple of 16.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int row0, int rows,
                                          int B, int row_elems) {
  const int vec_per_row = row_elems * static_cast<int>(sizeof(T)) / 16;
  const int total = rows * vec_per_row;
  uint4* d = reinterpret_cast<uint4*>(dst);
  const uint4* s = reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0) * row_elems);
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    d[i] = (row0 + i / vec_per_row < B) ? s[i] : make_uint4(0u, 0u, 0u, 0u);
  }
}

// SENet gate on a tile. S_s (TB, F, E) holds x on entry and
// S = rnd(x * rnd(w)) on exit, w = sigmoid(relu(z W1 + b1) W2 + b2) with
// z = mean_E(x); the gate is fp32 and cast to T before the product.
template <typename T>
__device__ void senet_gate(T* S_s, float* z_s, float* a_s, float* w_s,
                           const float* __restrict__ w1, const float* __restrict__ b1,
                           const float* __restrict__ w2, const float* __restrict__ b2,
                           int TB, int F, int E, int R) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int rf = warp; rf < TB * F; rf += nwarps) {
    const T* row = S_s + static_cast<size_t>(rf) * E;
    float acc = 0.f;
    for (int c = lane; c < E; c += 32) acc += to_f(row[c]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) z_s[rf] = acc / static_cast<float>(E);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TB * R; i += blockDim.x) {
    const int r = i / R, k = i % R;
    float acc = 0.f;
    for (int f = 0; f < F; ++f) acc += z_s[r * F + f] * w1[f * R + k];
    a_s[i] = fmaxf(acc + b1[k], 0.f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TB * F; i += blockDim.x) {
    const int r = i / F, f = i % F;
    float acc = 0.f;
    for (int k = 0; k < R; ++k) acc += a_s[r * R + k] * w2[k * F + f];
    w_s[i] = rnd<T>(1.f / (1.f + expf(-(acc + b2[f]))));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TB * F * E; i += blockDim.x) {
    S_s[i] = from_f<T>(to_f(S_s[i]) * w_s[i / E]);
  }
  __syncthreads();
}

// Columns [c0, c0 + ncols) of the rows x ld_src matrix src (global, T) into
// shared memory as fp32 rows of stride ld_dst; ncols, c0, ld_src and ld_dst
// % 8 == 0.
// A thread walks its pieces (row r, 8-column group g) by adding blockDim.x
// to r * ncols / 8 + g without dividing again: this load runs once per
// staged block, inside the kernels' inner loops.
template <typename T>
__device__ __forceinline__ void load_cols_f32(float* dst, int ld_dst, const T* src, int rows,
                                              int ld_src, int c0, int ncols) {
  if (ncols == ld_src && ncols == ld_dst) {  // whole rows: one contiguous piece
    load_block_f32(dst, src + c0, rows * ncols);
    return;
  }
  const int v8 = ncols / 8;
  const int dr = blockDim.x / v8, dg = blockDim.x % v8;
  int r = threadIdx.x / v8, g = threadIdx.x % v8;
  while (r < rows) {
    load8(dst + static_cast<size_t>(r) * ld_dst + g * 8,
          src + static_cast<size_t>(r) * ld_src + c0 + g * 8);
    r += dr;
    g += dg;
    if (g >= v8) {
      g -= v8;
      ++r;
    }
  }
}

// Width of the column blocks in which an (E, E) weight is staged: the
// largest divisor of E that is a multiple of 8 and keeps an (E, nc) block
// within max_elems elements (8 always divides E here).
inline int weight_block_cols(int E, size_t max_elems) {
  for (int nc = E; nc >= 8; nc -= 8) {
    if (E % nc == 0 && static_cast<size_t>(E) * nc <= max_elems) return nc;
  }
  return 0;
}

// One 4x4 tile of the bilinear projection V_p = S_p W for field p: rows
// r0..r0+3 of the tile, four columns; W_c points at the tile's first column
// inside a staged (E, ldw) fp32 column block of W. fp32 accumulation over
// k = 0..E-1 in order (so a column's sum is the same for any block width),
// then rounded to T.
template <typename T>
__device__ __forceinline__ void proj_tile(const T* S_s, const float* W_c, int ldw, int F, int E,
                                          int p, int r0, float v[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) v[i][j] = 0.f;
  const size_t rs = static_cast<size_t>(F) * E;
  const T* s0 = S_s + (static_cast<size_t>(r0) * F + p) * E;
  for (int k = 0; k < E; ++k) {
    const float4 w = *reinterpret_cast<const float4*>(W_c + static_cast<size_t>(k) * ldw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float s = to_f(s0[i * rs + k]);
      v[i][0] += s * w.x;
      v[i][1] += s * w.y;
      v[i][2] += s * w.z;
      v[i][3] += s * w.w;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) v[i][j] = rnd<T>(v[i][j]);
}

}  // namespace ctr
