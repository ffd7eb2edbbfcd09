// The fused SENet + bilinear + concat forward (see interaction.cu) as three
// building blocks on one stream, and the row helpers and gate it shares with
// the backward (interaction_bwd.cu). interaction.cu enqueues the blocks with
// the fp32 output of the TPU kernel, scoring.cu with the concat in the
// compute dtype T, the A operand of its tower's first product. The values
// are the same: every S element and every pair product is rounded to T
// before it is stored, so storing it as T loses nothing.
//
// Scratch is field-major, as in the backward: the Q = F - 1 projected fields
// p (1..F-1 for "all", whose V_0 no pair uses; 0..F-2 for "each") of a batch
// form one contiguous (Q B, E) matrix, each field one (B, E) slice.
//
//   1. gate: one warp a row, any F; w (B, F) fp32 and sc_p (Q, B, E) in T.
//      The forward rounds sc_p = cd(x_p cd(w_p)), the backward's
//      instantiation sc_p = cd(x_p w_p) (its TPU kernel's rounding points);
//   2. project: V = cd(sc W), the tile product of tile_mma.cuh ("all": one
//      (Q B, E) x (E, E) product; "each": Q groups of (B, E) x W_q in one
//      launch) with the EpiStoreCd epilogue, so V crosses memory in T;
//   3. pairs: one thread 16 bytes of output columns of a row (4 fp32 or 8
//      bf16); S = cd(x cd(w)) recomputed from x and w, V read once, and the
//      whole output row written once in 16-byte stores: the S columns, then
//      the pairs cd(S_i V_j) ("all") or cd(V_i S_j) ("each") in triu order.
//      The row's S stays in registers for F <= 8 (one instantiation a field
//      count) and is recomputed from x beyond.
#pragma once

#include "tile_mma.cuh"

namespace ctr {

constexpr int kRowsPerBlock = kThreads / 32;  // gate blocks: one warp a row

inline int last_error() { return static_cast<int>(cudaGetLastError()); }

// 8 fp32 values into 8 contiguous elements of T.
__device__ __forceinline__ void store8(float* dst, const float* v) {
  float4* d = reinterpret_cast<float4*>(dst);
  d[0] = make_float4(v[0], v[1], v[2], v[3]);
  d[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = u;
}

// 4 contiguous elements of T into fp32, and back.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void fma4(float4& acc, float4 a, float4 b) {
  acc.x += a.x * b.x;
  acc.y += a.y * b.y;
  acc.z += a.z * b.z;
  acc.w += a.w * b.w;
}
__device__ __forceinline__ float4 scale4(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Pair k of (i, j), i < j, in triu order.
__host__ __device__ __forceinline__ int pair_of(int i, int j, int F) {
  return i * (2 * F - i - 1) / 2 + (j - i - 1);
}

// The statements (...) with NF the constant F for 2 <= F <= 8, else NF = 0
// (any F): the kernels that hold a row's fields in registers have one
// instantiation a field count up to 8.
#define CTR_WITH_FIELDS(F, ...)                                   \
  switch (F) {                                                    \
    case 2: { constexpr int NF = 2; __VA_ARGS__; }                \
    case 3: { constexpr int NF = 3; __VA_ARGS__; }                \
    case 4: { constexpr int NF = 4; __VA_ARGS__; }                \
    case 5: { constexpr int NF = 5; __VA_ARGS__; }                \
    case 6: { constexpr int NF = 6; __VA_ARGS__; }                \
    case 7: { constexpr int NF = 7; __VA_ARGS__; }                \
    case 8: { constexpr int NF = 8; __VA_ARGS__; }                \
    default: { constexpr int NF = 0; __VA_ARGS__; }               \
  }

// ---- block 1: the gate, and sc field-major ----
// One warp a row, any F: z (F) and h1 (R) through the warp's slice of
// shared memory, and to z_out / h1_out when those are given (the
// backward's); w to w_out, which the warp reads back after __syncwarp (each
// h1 and gate pre-activation summed by one lane, in index order). FWD: sc_p
// = cd(x_p cd(w_p)), the forward's rounding; else sc_p = cd(x_p w_p).
template <typename T, bool FWD>
__global__ void __launch_bounds__(kThreads)
gate_kernel(const T* __restrict__ x, const float* __restrict__ w1, const float* __restrict__ b1,
            const float* __restrict__ w2, const float* __restrict__ b2, float* z_out,
            float* h1_out, float* w_out, T* __restrict__ sc, int B, int F, int E, int R,
            int poff) {
  extern __shared__ float gate_s[];  // (kRowsPerBlock, F + R): z then h1, a warp's row
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= B) return;  // the whole warp: the row is the warp's
  const T* xr = x + static_cast<size_t>(row) * F * E;
  float* zr = gate_s + warp * (F + R);
  float* hr = zr + F;
  float* wr = w_out + static_cast<size_t>(row) * F;
  for (int f0 = 0; f0 < F; f0 += 4) {  // four fields' loads in flight at once
    float z[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c = lane * 8; c < E; c += 256) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (f0 + j >= F) break;
        alignas(16) float v[8];
        load8(v, xr + (f0 + j) * E + c);
#pragma unroll
        for (int i = 0; i < 8; ++i) z[j] += v[i];
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + j;
      if (f >= F) break;  // the whole warp: f is uniform
      const float zf = warp_sum(z[j]);
      if (lane == 0) {
        zr[f] = zf / static_cast<float>(E);
        if (z_out) z_out[static_cast<size_t>(row) * F + f] = zr[f];
      }
    }
  }
  __syncwarp();
  for (int k = lane; k < R; k += 32) {
    float h = 0.f;
    for (int f = 0; f < F; ++f) h += zr[f] * w1[f * R + k];
    hr[k] = h + b1[k];
    if (h1_out) h1_out[static_cast<size_t>(row) * R + k] = hr[k];
  }
  __syncwarp();
  for (int f = lane; f < F; f += 32) {
    float a = 0.f;
    for (int k = 0; k < R; ++k) a += fmaxf(hr[k], 0.f) * w2[k * F + f];
    wr[f] = 1.f / (1.f + expf(-(a + b2[f])));  // the gate w
  }
  __syncwarp();
  for (int q = 0; q < F - 1; ++q) {
    const int p = q + poff;
    const float wp = FWD ? rnd<T>(wr[p]) : wr[p];
    T* dst = sc + (static_cast<size_t>(q) * B + row) * E;
    for (int c = lane * 8; c < E; c += 256) {
      alignas(16) float v[8];
      load8(v, xr + p * E + c);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] *= wp;
      store8(dst + c, v);
    }
  }
}

// N contiguous elements of T (N = 4 or 8) into fp32.
template <int N, typename T>
__device__ __forceinline__ void load_n(float* v, const T* p) {
  if constexpr (N == 8) {
    load8(v, p);
  } else {
    const float4 f = load4(p);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  }
}
// 16 bytes of the pairs pass's output (4 fp32 or 8 bf16 values), stored
// streaming (evict-first): the output is written once and not read back by
// this call, so it need not displace x and V from L2.
__device__ __forceinline__ void store_out(float* p, const float* v) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store_out(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  __stcs(reinterpret_cast<uint4*>(p), u);
}

// ---- block 3 of the forward: S and the pairs, each output row once ----
// Thread (row b, columns c..c+VEC-1), VEC = 16 bytes of OutT (4 fp32 or 8
// bf16), so that each store is 16 bytes and a warp's stores are contiguous.
// w (B, F) fp32; V (Q, B, E) in T. For each projected field d (q
// ascending) its columns of V meet each pair partner o: "all" pair (o, d)
// = cd(S_o V_d) for o < d = q + 1; "each" pair (d, o) = cd(V_d S_o) for o >
// d = q. NF > 0: F = NF, the row's S in registers; NF = 0: any F, S_o
// recomputed from x at each use.
template <typename T, bool EACH, int NF, typename OutT>
__global__ void __launch_bounds__(kThreads)
fwd_pairs_kernel(const T* __restrict__ x, const float* __restrict__ w, const T* __restrict__ V,
                 OutT* __restrict__ out, int B, int F_, int E) {
  constexpr int VEC = 16 / sizeof(OutT);
  const int F = NF > 0 ? NF : F_;
  const int ev = E / VEC;
  const size_t t = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
  const int b = static_cast<int>(t / ev);
  if (b >= B) return;
  const int c = static_cast<int>(t % ev) * VEC;
  const T* xr = x + static_cast<size_t>(b) * F * E + c;
  const float* wr = w + static_cast<size_t>(b) * F;
  OutT* orow = out + static_cast<size_t>(b) * (F + F * (F - 1) / 2) * E + c;
  auto s_of = [&](int f, float* v) {  // S_f = cd(x_f cd(w_f)), the thread's columns
    load_n<VEC>(v, xr + f * E);
    const float wf = rnd<T>(wr[f]);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = rnd<T>(v[i] * wf);
  };
  alignas(16) float s[NF > 0 ? NF : 1][VEC];  // load8 writes 16 bytes at a time
#pragma unroll
  for (int f = 0; f < F; ++f) {
    if constexpr (NF > 0) {
      s_of(f, s[f]);
      store_out(orow + f * E, s[f]);
    } else {
      alignas(16) float v[VEC];
      s_of(f, v);
      store_out(orow + f * E, v);
    }
  }
#pragma unroll
  for (int q = 0; q < F - 1; ++q) {
    const int d = EACH ? q : q + 1;
    alignas(16) float v[VEC];
    load_n<VEC>(v, V + (static_cast<size_t>(q) * B + b) * E + c);
#pragma unroll
    for (int o = EACH ? d + 1 : 0; o < (EACH ? F : d); ++o) {
      float p[VEC];
      if constexpr (NF > 0) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) p[i] = rnd<T>(s[o][i] * v[i]);
      } else {
        alignas(16) float so[VEC];
        s_of(o, so);
#pragma unroll
        for (int i = 0; i < VEC; ++i) p[i] = rnd<T>(so[i] * v[i]);
      }
      const int k = EACH ? pair_of(d, o, F) : pair_of(o, d, F);
      store_out(orow + static_cast<size_t>(F + k) * E, p);
    }
  }
}

// ---- host-side launches ----

inline bool fwd_in_envelope(int F, int E) { return F >= 2 && E >= 8 && E % 8 == 0; }

// z and h1 may be nullptr (the forward keeps them in shared memory only).
template <typename T, bool FWD>
int launch_gate(const T* x, const float* w1, const float* b1, const float* w2, const float* b2,
                float* z, float* h1, float* w, T* sc, int B, int F, int E, int R, bool each,
                cudaStream_t s) {
  const size_t smem = sizeof(float) * kRowsPerBlock * (F + R);
  auto kern = gate_kernel<T, FWD>;
  if (smem > 48 * 1024) {  // above 48 KB only when asked for, at every launch (no static flag)
    const cudaError_t set = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  kern<<<(B + kRowsPerBlock - 1) / kRowsPerBlock, kThreads, smem, s>>>(
      x, w1, b1, w2, b2, z, h1, w, sc, B, F, E, R, each ? 0 : 1);
  return last_error();
}

// V = cd(sc W) (Q, B, E) in T ("all": one (Q B, E) x (E, E) product; "each":
// Q of (B, E) x W_q).
template <typename T>
int launch_fwd_project(const T* sc, const T* wbi, T* V, int B, int F, int E, bool each,
                       cudaStream_t s) {
  const int Q = F - 1;
  const size_t be = static_cast<size_t>(B) * E, ee = static_cast<size_t>(E) * E;
  const mma::EpiStoreCd<T> epi{V, E, be};
  if (each)
    return mma::launch_product<T, false, true>(sc, wbi, B, E, E, 1, E, epi, s, Q, be, ee);
  return mma::launch_product<T, false, true>(sc, wbi, Q * B, E, E, 1, E, epi, s);
}

template <typename T, typename OutT>
int launch_fwd_pairs(const T* x, const float* w, const T* V, OutT* out, int B, int F, int E,
                     bool each, cudaStream_t s) {
  const size_t threads = static_cast<size_t>(B) * (E / (16 / sizeof(OutT)));
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  if (each) {
    CTR_WITH_FIELDS(F, fwd_pairs_kernel<T, true, NF, OutT><<<blocks, kThreads, 0, s>>>(
                           x, w, V, out, B, F, E);
                    return last_error())
  }
  CTR_WITH_FIELDS(F, fwd_pairs_kernel<T, false, NF, OutT><<<blocks, kThreads, 0, s>>>(
                         x, w, V, out, B, F, E);
                  return last_error())
}

// The forward's scratch, carved from one workspace (each piece 256-byte
// aligned): w (B, F) fp32, sc and V (Q, B, E) in T. With base == nullptr
// only its size is counted.
struct FwdWork {
  float* w;
  void *sc, *V;
  size_t bytes;
  FwdWork(char* base, int B, int F, int E, size_t esize) {
    size_t used = 0;
    auto take = [&](size_t n) {
      void* p = base ? base + used : nullptr;
      used += (n + 255) / 256 * 256;
      return p;
    };
    const size_t qbe = static_cast<size_t>(F - 1) * B * E;
    w = static_cast<float*>(take(sizeof(float) * B * F));
    sc = take(esize * qbe);
    V = take(esize * qbe);
    bytes = used;
  }
};

// The whole forward, blocks 1-3 in order on one stream, into out (B, (F +
// F(F-1)/2) E) of OutT; workspace holds FwdWork's bytes. Returns the first
// cudaError_t (cudaErrorInvalidValue outside the envelope).
template <typename T, typename OutT>
int launch_interaction_fwd(const T* x, const float* w1, const float* b1, const float* w2,
                           const float* b2, const T* wbi, OutT* out, void* workspace, int B,
                           int F, int E, int R, bool each, cudaStream_t s) {
  if (B < 1 || R < 1 || !fwd_in_envelope(F, E)) return static_cast<int>(cudaErrorInvalidValue);
  const FwdWork k(static_cast<char*>(workspace), B, F, E, sizeof(T));
  T* sc = static_cast<T*>(k.sc);
  T* V = static_cast<T*>(k.V);
  int rc = launch_gate<T, true>(x, w1, b1, w2, b2, nullptr, nullptr, k.w, sc, B, F, E, R, each, s);
  if (rc == 0) rc = launch_fwd_project<T>(sc, wbi, V, B, F, E, each, s);
  if (rc == 0) rc = launch_fwd_pairs<T, OutT>(x, k.w, V, out, B, F, E, each, s);
  return rc;
}

}  // namespace ctr
