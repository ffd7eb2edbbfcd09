// BatchNorm, ReLU and dropout after a tower layer's GEMM, both ways, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the tower to XLA
// (ctr_recommendation_tpu/ops/mlp.py), and on the card the port ran it as a
// chain of library kernels (the bias add, the cast to fp32, mean and var,
// the normalise-and-affine, ReLU, dropout's compare, divide and select, and
// autograd's backward of each). One layer, with y = x W from cuBLAS (rows,
// n) in the tower's dtype cd (bf16 or fp32), the bias b, the BatchNorm
// affine gamma, beta, the optional row weights w (0/1; 1 without) and the
// dropout's uniforms u (torch.rand's, fp32; none at rate 0), keep = 1 - rate:
//
//   h = y + b (fp32); S = sum w, N = max(S, 1);
//   mean = sum w h / N, var = sum w (h - mean)^2 / N (biased);
//   inv = 1 / sqrt(var + eps), a = gamma inv, c = beta - mean a;
//   z = a h + c, code = (z > 0) and (u < keep);
//   out = code ? z s : 0, in cd, s = 1 / keep; code kept as one bit an element;
//   running mean <- 0.9 running + 0.1 mean,
//   running var <- 0.9 running + 0.1 var N / max(N - 1, 1).
//
// Backward, from dout (cd): g = code ? dout s : 0, xh = (h - mean) inv;
//   dbeta = sum g, dgamma = sum g xh (every row);
//   dh = a (g - w (dbeta + xh dgamma) (1 / N)), in cd, for cuBLAS's dW and dx;
//   db = sum dh.
// Without BatchNorm a = 1, c = 0 and dh = g. y is kept for the backward, not
// the normalised tensor: it is recomputed where it is read.
//
// Passes (grid: column tiles of 32 V columns x row chunks; each of a block's
// 8 warps takes every 8th row of the chunk, each lane V columns, V = 16
// bytes of cd where n allows, else 1):
//   forward: col_pass<kSum> (sum w h and S) and reduce_chunks, col_pass<kDev>
//   (sum w (h - mean)^2) and reduce_chunks, apply_pass (out, code, the
//   running statistics): 5 launches; without BatchNorm apply_pass alone.
//   backward: col_pass<kGrad> (dbeta, dgamma) and reduce_chunks, col_pass<kDx>
//   (dh and sum dh) and reduce_chunks: 4 launches; without BatchNorm the
//   last two.
// A data-parallel step all-reduces the sums between the launches (the
// wrapper, ops/cuda/tower.py): the statistics and the backward's two sums
// run over the global batch, as ops/mlp.py computes them.
//
// No float atomics: each lane adds its rows in order, a block's warps are
// added in warp order, and reduce_chunks adds a column's chunk partials in
// a fixed order, all fixed by (rows, n) alone (tower_plan): the same inputs
// give the same bits on every call.
//
// Bound on an H100: bytes. At 131,072 x 512 in bf16 (134 MB a tensor) the
// forward reads y three times and u (268 MB) once and writes out and the
// code (8 MB); the backward reads dout, y and the code twice and writes dh:
// ~1.4 GB, 0.42 ms at 3.35 TB/s; the partials (chunks x n floats) and the
// column vectors are noise beside that. Every pass streams its rows once in
// 16-byte loads, kRows rows of a warp loaded before any is used (their
// loads in flight together); the running statistics come from the apply
// pass's first chunk. A call on no rows (a data-parallel rank without rows
// of the batch) runs one empty chunk: zero partials, and the running
// statistics from the sums it is given.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "common.cuh"

namespace ctr {
namespace tower {

constexpr int kWarps = 8;                 // warps a block: rows r0 + w, r0 + w + 8, ...
constexpr int kRows = 4;                  // rows a warp loads before it computes on them
constexpr int kBlockThreads = 32 * kWarps;
constexpr long long kTargetBlocks = 528;  // blocks a pass aims at: 4 an SM of an H100
constexpr long long kMinChunk = 64;       // fewest rows a chunk
constexpr int kReduceWarps = 8;           // warps a block of reduce_chunks (32 columns)
constexpr float kEps = 1e-5f;             // BatchNorm's eps
constexpr float kMomentum = 0.1f;         // BatchNorm's momentum
constexpr float kStay = 0.9f;             // 1 - momentum

enum Mode { kSum = 0, kDev = 1, kGrad = 2, kDx = 3 };

inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// The call's geometry, a pure function of the shapes.
struct Plan {
  int vec, tiles;
  long long chunk_rows, chunks;
};

inline Plan make_plan(long long rows, long long n, int bf16) {
  Plan p;
  const int wide = bf16 ? 8 : 4;  // 16 bytes of cd
  p.vec = n % wide == 0 ? wide : 1;
  p.tiles = static_cast<int>(cdiv(n, 32LL * p.vec));
  const long long want = kTargetBlocks / p.tiles > 1 ? kTargetBlocks / p.tiles : 1;
  const long long per = cdiv(cdiv(rows, want), kWarps) * kWarps;
  p.chunk_rows = per > kMinChunk ? per : kMinChunk;
  p.chunks = rows > 0 ? cdiv(rows, p.chunk_rows) : 1;  // no rows: one empty chunk
  return p;
}

// Every operand of a pass; a pass reads the ones it needs.
struct Args {
  const void* y;         // (rows, n) cd: the GEMM's output, before the bias
  const void* dout;      // (rows, n) cd: the output's cotangent
  const float* bias;     // (n,) or null
  const float* weight;   // (rows,) or null: every row weighs 1
  const float* u;        // (rows, n) or null: no dropout
  const float* gamma;    // (n,) or null: no BatchNorm
  const float* beta;     // (n,)
  const float* sums;     // (n + 1,): sum w h, then S
  const float* devs;     // (n,): sum w (h - mean)^2
  const float* gsums;    // (2n,): dbeta, then dgamma
  const float* run_mean;
  const float* run_var;
  float* new_mean;
  float* new_var;
  void* out;             // (rows, n) cd: the forward's output, or dh
  uint8_t* code;         // (rows, wb): bit k of byte m is column 8 m + k
  float* part;           // (chunks, ld): a chunk's partial sums
  long long rows, chunk_rows;
  int n, ld, wb;
  float keep;            // 1 - rate: u < keep keeps an element
  float scale;           // 1 / keep, rounded once (the host's): kept elements are scaled by it
};

// V elements of T as one load: 16 bytes, or one element.
template <typename T, int V> struct Raw {
  using type = uint4;
};
template <typename T> struct Raw<T, 1> {
  using type = T;
};

template <typename T, int V>
__device__ __forceinline__ typename Raw<T, V>::type load_raw(const T* p) {
  return *reinterpret_cast<const typename Raw<T, V>::type*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void widen(const typename Raw<T, V>::type& raw, float* v) {
  if constexpr (V == 1) {
    v[0] = to_f<T>(raw);
  } else {
    static_assert(V * sizeof(T) == 16, "a vector is 16 bytes");
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = to_f<T>(e[k]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float* v) {
  if constexpr (V == 1) {
    *p = from_f<T>(v[0]);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int k = 0; k < V; ++k) e[k] = from_f<T>(v[k]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// V fp32 values as loaded (the uniforms).
template <int V> struct Floats {
  float4 q[V / 4];
  __device__ __forceinline__ void load(const float* p) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) q[i] = reinterpret_cast<const float4*>(p)[i];
  }
  __device__ __forceinline__ float operator[](int k) const {
    const float4& f = q[k / 4];
    return (k & 3) == 0 ? f.x : (k & 3) == 1 ? f.y : (k & 3) == 2 ? f.z : f.w;
  }
};
template <> struct Floats<1> {
  float q;
  __device__ __forceinline__ void load(const float* p) { q = *p; }
  __device__ __forceinline__ float operator[](int) const { return q; }
};

// Store this lane's V code bits (bit k: column j0 + k) into its row's bytes.
// Every lane of the warp calls it with the same row (V < 8 combines lanes).
template <int V>
__device__ __forceinline__ void store_code(uint8_t* row, int j0, int n, unsigned bits, int lane) {
  if constexpr (V == 8) {
    if (j0 < n) row[j0 >> 3] = static_cast<uint8_t>(bits);
  } else if constexpr (V == 4) {
    const unsigned hi = __shfl_down_sync(0xffffffffu, bits, 1);
    if (!(lane & 1) && j0 < n) row[j0 >> 3] = static_cast<uint8_t>(bits | (hi << 4));
  } else {
    const unsigned all = __ballot_sync(0xffffffffu, bits & 1u);
    if (!(lane & 7) && j0 < n) row[j0 >> 3] = static_cast<uint8_t>(all >> lane);
  }
}

template <int V>
__device__ __forceinline__ unsigned load_code(const uint8_t* row, int j0) {
  const unsigned byte = row[j0 >> 3];
  if constexpr (V == 8) return byte;
  else if constexpr (V == 4) return (byte >> (j0 & 4)) & 0xFu;
  else return (byte >> (j0 & 7)) & 1u;
}

// Column j's constants: the bias, and with BatchNorm the mean (from sums)
// and, where devs are given, inv, a and c. Outside [0, n) and without
// BatchNorm: mean 0, inv 1, a 1, c 0. Rounded as ops/cuda/tower.py's plain
// version rounds (no contraction into fused multiply-adds).
struct Col {
  float b, mean, inv, a, c;
};

__device__ __forceinline__ Col col_of(const Args& g, int j) {
  Col s{0.f, 0.f, 1.f, 1.f, 0.f};
  if (j >= g.n) return s;
  if (g.bias) s.b = g.bias[j];
  if (!g.sums) return s;
  const float cnt = fmaxf(g.sums[g.n], 1.f);
  s.mean = __fdiv_rn(g.sums[j], cnt);
  if (!g.devs) return s;
  s.inv = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(__fdiv_rn(g.devs[j], cnt), kEps)));
  s.a = __fmul_rn(g.gamma[j], s.inv);
  s.c = __fsub_rn(g.beta[j], __fmul_rn(s.mean, s.a));
  return s;
}

// The column passes: each lane adds its columns over its rows of the chunk
// in row order; the block's warps are added in warp order into part[chunk].
// kSum: sum w h (and, in tile 0, S at part[n]); kDev: sum w (h - mean)^2;
// kGrad: sum g at part[j], sum g xh at part[n + j]; kDx: dh stored as out
// and sum dh at part[j].
template <typename T, int V, int MODE>
__global__ void __launch_bounds__(kBlockThreads) col_pass(Args g) {
  constexpr int kAcc = MODE == kGrad ? 2 : 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j0 = blockIdx.x * 32 * V + lane * V;
  const bool valid = j0 < g.n;
  const long long r0 = static_cast<long long>(blockIdx.y) * g.chunk_rows;
  const long long r1 = r0 + g.chunk_rows < g.rows ? r0 + g.chunk_rows : g.rows;
  const T* y = static_cast<const T*>(g.y);
  const T* dout = static_cast<const T*>(g.dout);
  float b[V], mean[V], inv[V], a[V], gb[V], gg[V];
  const bool bn = g.sums != nullptr;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const Col s = col_of(g, j0 + k);
    b[k] = s.b;
    mean[k] = s.mean;
    inv[k] = s.inv;
    a[k] = s.a;
    gb[k] = gg[k] = 0.f;
    if (MODE == kDx && bn && valid) {
      gb[k] = g.gsums[j0 + k];
      gg[k] = g.gsums[g.n + j0 + k];
    }
  }
  const float rcnt = bn ? __fdiv_rn(1.f, fmaxf(g.sums[g.n], 1.f)) : 1.f;  // 1 / N
  float acc[kAcc][V];
#pragma unroll
  for (int i = 0; i < kAcc; ++i)
#pragma unroll
    for (int k = 0; k < V; ++k) acc[i][k] = 0.f;
  float wacc = 0.f;
  // kRows rows of the warp loaded, then added in row order
  for (long long r = r0 + warp; r < r1; r += kRows * kWarps) {
    typename Raw<T, V>::type ry[kRows], rd[kRows];
    unsigned bits[kRows];
    float w[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const long long rq = r + q * kWarps;
      w[q] = g.weight && rq < r1 ? g.weight[rq] : 1.f;
      if (rq < r1 && valid) {
        const size_t at = static_cast<size_t>(rq) * g.n + j0;
        ry[q] = load_raw<T, V>(y + at);
        if constexpr (MODE == kGrad || MODE == kDx) {
          rd[q] = load_raw<T, V>(dout + at);
          bits[q] = load_code<V>(g.code + static_cast<size_t>(rq) * g.wb, j0);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const long long rq = r + q * kWarps;
      if (rq >= r1) break;
      if (MODE == kSum) wacc += w[q];
      if (!valid) continue;
      float h[V];
      widen<T, V>(ry[q], h);
#pragma unroll
      for (int k = 0; k < V; ++k) h[k] = __fadd_rn(h[k], b[k]);
      if constexpr (MODE == kSum) {
#pragma unroll
        for (int k = 0; k < V; ++k) acc[0][k] += g.weight ? __fmul_rn(w[q], h[k]) : h[k];
      } else if constexpr (MODE == kDev) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float d = __fsub_rn(h[k], mean[k]);
          const float dd = __fmul_rn(d, d);
          acc[0][k] += g.weight ? __fmul_rn(w[q], dd) : dd;
        }
      } else {
        float dv[V], dh[V];
        widen<T, V>(rd[q], dv);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float gk = (bits[q] >> k) & 1u ? __fmul_rn(dv[k], g.scale) : 0.f;
          const float xh = __fmul_rn(__fsub_rn(h[k], mean[k]), inv[k]);
          if constexpr (MODE == kGrad) {
            acc[0][k] += gk;
            acc[1][k] += __fmul_rn(gk, xh);
          } else {
            if (bn) {
              float t = __fadd_rn(gb[k], __fmul_rn(xh, gg[k]));
              if (g.weight) t = __fmul_rn(w[q], t);
              dh[k] = __fmul_rn(a[k], __fsub_rn(gk, __fmul_rn(t, rcnt)));
            } else {
              dh[k] = gk;
            }
            acc[0][k] += dh[k];
          }
        }
        if constexpr (MODE == kDx)
          store_vec<T, V>(static_cast<T*>(g.out) + static_cast<size_t>(rq) * g.n + j0, dh);
      }
    }
  }
  __shared__ float red[kWarps][kAcc][32 * V];
  __shared__ float wred[kWarps];
#pragma unroll
  for (int i = 0; i < kAcc; ++i)
#pragma unroll
    for (int k = 0; k < V; ++k) red[warp][i][lane * V + k] = acc[i][k];
  if (lane == 0) wred[warp] = wacc;
  __syncthreads();
  if (warp != 0) return;
  float* dst = g.part + static_cast<size_t>(blockIdx.y) * g.ld;
  if (valid) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i)
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float s = red[0][i][lane * V + k];
#pragma unroll
        for (int q = 1; q < kWarps; ++q) s += red[q][i][lane * V + k];
        dst[i * g.n + j0 + k] = s;
      }
  }
  if (MODE == kSum && blockIdx.x == 0 && lane == 0) {
    float s = wred[0];
#pragma unroll
    for (int q = 1; q < kWarps; ++q) s += wred[q];
    dst[g.n] = s;
  }
}

// The forward's output and code, and (the first chunk's blocks) the running
// statistics.
template <typename T, int V>
__global__ void __launch_bounds__(kBlockThreads) apply_pass(Args g) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j0 = blockIdx.x * 32 * V + lane * V;
  const bool valid = j0 < g.n;
  const long long r0 = static_cast<long long>(blockIdx.y) * g.chunk_rows;
  const long long r1 = r0 + g.chunk_rows < g.rows ? r0 + g.chunk_rows : g.rows;
  float b[V], a[V], c[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const Col s = col_of(g, j0 + k);
    b[k] = s.b;
    a[k] = s.a;
    c[k] = s.c;
    if (g.sums && valid && blockIdx.y == 0 && warp == 0) {
      const int j = j0 + k;
      const float cnt = fmaxf(g.sums[g.n], 1.f);
      const float var = __fdiv_rn(g.devs[j], cnt);
      const float unbiased = __fmul_rn(var, __fdiv_rn(cnt, fmaxf(__fsub_rn(cnt, 1.f), 1.f)));
      g.new_mean[j] = __fadd_rn(__fmul_rn(kStay, g.run_mean[j]), __fmul_rn(kMomentum, s.mean));
      g.new_var[j] = __fadd_rn(__fmul_rn(kStay, g.run_var[j]), __fmul_rn(kMomentum, unbiased));
    }
  }
  const T* y = static_cast<const T*>(g.y);
  T* out = static_cast<T*>(g.out);
  for (long long r = r0 + warp; r < r1; r += kRows * kWarps) {
    typename Raw<T, V>::type ry[kRows];
    Floats<V> ru[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const long long rq = r + q * kWarps;
      if (rq < r1 && valid) {
        const size_t at = static_cast<size_t>(rq) * g.n + j0;
        ry[q] = load_raw<T, V>(y + at);
        if (g.u) ru[q].load(g.u + at);
      }
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const long long rq = r + q * kWarps;
      if (rq >= r1) break;
      unsigned bits = 0;
      if (valid) {
        float h[V], o[V];
        widen<T, V>(ry[q], h);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float z = __fadd_rn(__fmul_rn(a[k], __fadd_rn(h[k], b[k])), c[k]);
          const bool on = z > 0.f && (!g.u || ru[q][k] < g.keep);
          bits |= static_cast<unsigned>(on) << k;
          o[k] = on ? __fmul_rn(z, g.scale) : 0.f;
        }
        store_vec<T, V>(out + static_cast<size_t>(rq) * g.n + j0, o);
      }
      store_code<V>(g.code + static_cast<size_t>(rq) * g.wb, j0, g.n, bits, lane);
    }
  }
}

// out[j] = the chunks' partials of column j added in a fixed order: warp w
// adds chunks w, w + 8, ... in order, then the 8 warps in warp order.
__global__ void __launch_bounds__(32 * kReduceWarps)
reduce_chunks(const float* __restrict__ part, long long chunks, int ld, int count,
              float* __restrict__ out) {
  __shared__ float red[kReduceWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (j < count) {
#pragma unroll 8
    for (long long p = warp; p < chunks; p += kReduceWarps) s += part[p * ld + j];
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && j < count) {
    float t = red[0][lane];
#pragma unroll
    for (int q = 1; q < kReduceWarps; ++q) t += red[q][lane];
    out[j] = t;
  }
}

template <typename T, int MODE>
cudaError_t launch_cols(const Args& g, const Plan& p, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(p.tiles), static_cast<unsigned>(p.chunks));
  if (p.vec == 1)
    col_pass<T, 1, MODE><<<grid, kBlockThreads, 0, st>>>(g);
  else
    col_pass<T, 16 / sizeof(T), MODE><<<grid, kBlockThreads, 0, st>>>(g);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_cols_cd(const Args& g, const Plan& p, int bf16, cudaStream_t st) {
  return bf16 ? launch_cols<__nv_bfloat16, MODE>(g, p, st) : launch_cols<float, MODE>(g, p, st);
}

inline cudaError_t launch_reduce(const Args& g, const Plan& p, int count, float* out,
                                 cudaStream_t st) {
  reduce_chunks<<<static_cast<unsigned>(cdiv(count, 32)), 32 * kReduceWarps, 0, st>>>(
      g.part, p.chunks, g.ld, count, out);
  return cudaGetLastError();
}

inline bool bad(long long rows, long long n) {
  return rows < 0 || n < 1 || n > (1LL << 30) || rows > (1LL << 40);
}

inline Args args(long long rows, int n, const Plan& p) {
  Args g{};
  g.rows = rows;
  g.n = n;
  g.chunk_rows = p.chunk_rows;
  g.wb = static_cast<int>(cdiv(n, 8));
  g.keep = g.scale = 1.f;
  return g;
}

}  // namespace tower
}  // namespace ctr

namespace tw = ctr::tower;

// The geometry of a call (ops/cuda/tower.py::plan): out[0] the vector width,
// out[1] column tiles, out[2] rows a chunk, out[3] chunks. Returns 0, or 1
// for no columns or a negative row count.
extern "C" int tower_plan(long long rows, long long n, int bf16, long long* out) {
  if (tw::bad(rows, n)) return 1;
  const tw::Plan p = tw::make_plan(rows, n, bf16);
  out[0] = p.vec;
  out[1] = p.tiles;
  out[2] = p.chunk_rows;
  out[3] = p.chunks;
  return 0;
}

// Forward, statistics: sums (n + 1) = (sum w h, S). part holds chunks x
// (n + 1) floats. 2 launches.
extern "C" int tower_fwd_sums(const void* y, const float* bias, const float* weight, float* part,
                              float* sums, long long rows, int n, int bf16, void* stream) {
  if (tw::bad(rows, n)) return static_cast<int>(cudaErrorInvalidValue);
  const tw::Plan p = tw::make_plan(rows, n, bf16);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  tw::Args g = tw::args(rows, n, p);
  g.y = y;
  g.bias = bias;
  g.weight = weight;
  g.part = part;
  g.ld = n + 1;
  cudaError_t e = tw::launch_cols_cd<tw::kSum>(g, p, bf16, st);
  return static_cast<int>(e != cudaSuccess ? e : tw::launch_reduce(g, p, n + 1, sums, st));
}

// Forward, deviations: devs (n) = sum w (h - mean)^2, the mean from sums
// (over the global batch in a data-parallel step). part holds chunks x n
// floats. 2 launches.
extern "C" int tower_fwd_devs(const void* y, const float* bias, const float* weight,
                              const float* sums, float* part, float* devs, long long rows, int n,
                              int bf16, void* stream) {
  if (tw::bad(rows, n) || !sums) return static_cast<int>(cudaErrorInvalidValue);
  const tw::Plan p = tw::make_plan(rows, n, bf16);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  tw::Args g = tw::args(rows, n, p);
  g.y = y;
  g.bias = bias;
  g.weight = weight;
  g.sums = sums;
  g.part = part;
  g.ld = n;
  cudaError_t e = tw::launch_cols_cd<tw::kDev>(g, p, bf16, st);
  return static_cast<int>(e != cudaSuccess ? e : tw::launch_reduce(g, p, n, devs, st));
}

// Forward, output: out (cd) and code; with BatchNorm (sums, devs, gamma,
// beta given) the new running statistics. u null: no dropout; keep = 1 -
// rate and scale = 1 / keep (rounded by the caller). 1 launch.
extern "C" int tower_fwd_apply(const void* y, const float* bias, const float* gamma,
                               const float* beta, const float* sums, const float* devs,
                               const float* u, float keep, float scale, const float* run_mean,
                               const float* run_var, float* new_mean, float* new_var, void* out,
                               uint8_t* code, long long rows, int n, int bf16, void* stream) {
  if (tw::bad(rows, n) || (sums && (!devs || !gamma || !beta || !run_mean || !run_var ||
                                    !new_mean || !new_var)))
    return static_cast<int>(cudaErrorInvalidValue);
  const tw::Plan p = tw::make_plan(rows, n, bf16);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  tw::Args g = tw::args(rows, n, p);
  g.y = y;
  g.bias = bias;
  g.gamma = gamma;
  g.beta = beta;
  g.sums = sums;
  g.devs = devs;
  g.u = u;
  g.keep = keep;
  g.scale = scale;
  g.run_mean = run_mean;
  g.run_var = run_var;
  g.new_mean = new_mean;
  g.new_var = new_var;
  g.out = out;
  g.code = code;
  const dim3 grid(static_cast<unsigned>(p.tiles), static_cast<unsigned>(p.chunks));
  if (bf16) {
    using T = __nv_bfloat16;
    if (p.vec == 1)
      tw::apply_pass<T, 1><<<grid, tw::kBlockThreads, 0, st>>>(g);
    else
      tw::apply_pass<T, 8><<<grid, tw::kBlockThreads, 0, st>>>(g);
  } else {
    if (p.vec == 1)
      tw::apply_pass<float, 1><<<grid, tw::kBlockThreads, 0, st>>>(g);
    else
      tw::apply_pass<float, 4><<<grid, tw::kBlockThreads, 0, st>>>(g);
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward, sums (BatchNorm only): gsums (2n) = (sum g, sum g xh) over this
// call's rows. part holds chunks x 2n floats. 2 launches.
extern "C" int tower_bwd_sums(const void* dout, const void* y, const uint8_t* code,
                              const float* bias, const float* gamma, const float* beta,
                              const float* sums, const float* devs, float scale, float* part,
                              float* gsums, long long rows, int n, int bf16, void* stream) {
  if (tw::bad(rows, n) || !sums || !devs || !gamma || !beta)
    return static_cast<int>(cudaErrorInvalidValue);
  const tw::Plan p = tw::make_plan(rows, n, bf16);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  tw::Args g = tw::args(rows, n, p);
  g.dout = dout;
  g.y = y;
  g.code = const_cast<uint8_t*>(code);
  g.bias = bias;
  g.gamma = gamma;
  g.beta = beta;
  g.sums = sums;
  g.devs = devs;
  g.scale = scale;
  g.part = part;
  g.ld = 2 * n;
  cudaError_t e = tw::launch_cols_cd<tw::kGrad>(g, p, bf16, st);
  return static_cast<int>(e != cudaSuccess ? e : tw::launch_reduce(g, p, 2 * n, gsums, st));
}

// Backward, dh (cd) and db (n) = sum dh; with BatchNorm (sums, devs, gamma,
// beta and gsums, the backward sums over the global batch, given) dh takes
// the statistics' terms. part holds chunks x n floats. 2 launches.
extern "C" int tower_bwd_dx(const void* dout, const void* y, const uint8_t* code,
                            const float* bias, const float* gamma, const float* beta,
                            const float* sums, const float* devs, const float* gsums,
                            const float* weight, float scale, void* dh, float* part, float* db,
                            long long rows, int n, int bf16, void* stream) {
  if (tw::bad(rows, n) || (sums && (!devs || !gamma || !beta || !gsums)))
    return static_cast<int>(cudaErrorInvalidValue);
  const tw::Plan p = tw::make_plan(rows, n, bf16);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  tw::Args g = tw::args(rows, n, p);
  g.dout = dout;
  g.y = y;
  g.code = const_cast<uint8_t*>(code);
  g.bias = bias;
  g.gamma = gamma;
  g.beta = beta;
  g.sums = sums;
  g.devs = devs;
  g.gsums = gsums;
  g.weight = weight;
  g.scale = scale;
  g.out = dh;
  g.part = part;
  g.ld = n;
  cudaError_t e = tw::launch_cols_cd<tw::kDx>(g, p, bf16, st);
  return static_cast<int>(e != cudaSuccess ? e : tw::launch_reduce(g, p, n, db, st));
}
