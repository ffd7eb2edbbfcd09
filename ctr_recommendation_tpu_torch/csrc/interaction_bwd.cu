// Backward of the fused SENet + bilinear + concat block for Hopper (sm_90a).
//
// Replaces the TPU kernel ctr_recommendation_tpu/ops/pallas/interaction.py
// ::_bwd_kernel (:250), driven there by _pallas_backward (:377). Given the
// cotangent g of out = [S | pairs] and the forward's input x, it recomputes
// the gate and the projections and runs the hand-derived VJP:
//
//   z = mean_E(x); h1 = z W1 + b1; a = relu(h1); w = sigmoid(a W2 + b2)
//   s_f = x_f * w_f                         (fp32, not rounded)
//   v_p = cd(s_p) W_p                       (fp32 accumulation, not rounded)
//   "all":  p_k = s_i * v_j   ->  ds_i += g_k v_j,  dv_j += g_k s_i
//   "each": p_k = v_i * s_j   ->  dv_i += g_k s_j,  ds_j += g_k v_i
//   dW_p += cd(s_p)^T cd(dv_p);  ds_p += cd(dv_p) cd(W_p)^T
//   gate: dh2 = sum_E(ds * x) w (1 - w); dW2, db2, dW1, db1 and
//   dz = ((dh2 W2^T) * [h1 > 0]) W1^T;  dx = ds * w + dz / E
//
// cd() is a cast to the compute dtype T (x's dtype); every other value is
// fp32. These are the TPU kernel's rounding points, which differ from the
// forward's (there the gate is rounded before x * w and V after the dot).
//
// Bound on an H100: bytes. At B=4096, F=6, E=128 with bf16 x it must read
// g (44.0 MB fp32) and x (6.3 MB) and write dx (6.3 MB); the 2.4 GFLOP of
// projections are far below the card's compute line.
//
// Design. A block of 256 threads owns TB rows at a time (TB = 32 in bf16, 12
// in fp32: what 227 KB of shared memory holds) and keeps x, the fp32 ds
// accumulator, W and W^T (both in T) and the small gate vectors there. g is
// streamed from device memory once, one E-wide chunk per field or pair, as
// 16-byte loads. For each projected field p, a thread computes a 4x4 tile of
// v_p in registers, walks every pair that uses v_p, adds into ds in shared
// memory and accumulates the matching 4x4 tile of dv_p in registers; dv_p is
// complete at that point (each pair's dv goes to exactly one projected
// field), so it is rounded into a (TB, E) buffer and its two products run
// at once. The weight gradients are summed over the batch without atomics:
// the grid is persistent (at most one block per SM, each looping over row
// tiles in a fixed order) and each block adds into its own fp32 partial in
// device memory; a second launch reduces the partials in block order. Two
// launches on the same inputs are therefore bit-identical. Rows past B are
// zero-filled in shared memory, read no g and write no dx, so they add
// exactly zero. The products run as fp32 FMA on the CUDA cores: simple first.

#include "common.cuh"

namespace ctr {

constexpr int kMaxE = 128;  // dW accumulators: E*E/4/kThreads float4 per thread
constexpr int kMaxVec = kMaxE * kMaxE / 4 / kThreads;

struct BwdLayout {
  size_t x, ds, dvc, w, wt, small, total;
};

// Shared memory of one block: x (TB,F,E) in T, ds (TB,F,E) fp32, dvc (TB,E)
// in T, W and W^T (E,E) in T, then z, w, dh2, dz (TB,F) and h1, dh1 (TB,R).
template <typename T>
__host__ __device__ inline BwdLayout bwd_layout(int TB, int F, int E, int R) {
  BwdLayout L;
  size_t o = 0;
  L.x = o;
  o += align16(static_cast<size_t>(TB) * F * E * sizeof(T));
  L.ds = o;
  o += align16(static_cast<size_t>(TB) * F * E * sizeof(float));
  L.dvc = o;
  o += align16(static_cast<size_t>(TB) * E * sizeof(T));
  L.w = o;
  o += align16(static_cast<size_t>(E) * E * sizeof(T));
  L.wt = o;
  o += align16(static_cast<size_t>(E) * E * sizeof(T));
  L.small = o;
  o += static_cast<size_t>(TB) * (4 * F + 2 * R) * sizeof(float);
  L.total = o;
  return L;
}

template <typename T>
static int tile_rows(int F, int E, int R) {
  for (int tb = 32; tb >= 4; tb -= 4) {
    if (bwd_layout<T>(tb, F, E, R).total <= kMaxSmem) return tb;
  }
  return 0;
}

__device__ __forceinline__ void load4(float* dst, const float* src) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

__device__ __forceinline__ void load4(float* dst, const __nv_bfloat16* src) {
  const uint2 u = *reinterpret_cast<const uint2*>(src);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
  dst[0] = __bfloat162float(h[0]);
  dst[1] = __bfloat162float(h[1]);
  dst[2] = __bfloat162float(h[2]);
  dst[3] = __bfloat162float(h[3]);
}

__device__ __forceinline__ void store4(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float* v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned int*>(&lo);
  u.y = *reinterpret_cast<const unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
}

// W (E,E) from device memory into W_s and its transpose into WT_s, both in T.
template <typename T>
__device__ __forceinline__ void load_weight(T* W_s, T* WT_s, const T* __restrict__ w, int E) {
  for (int i = threadIdx.x; i < E * E; i += blockDim.x) {
    const T v = w[i];
    W_s[i] = v;
    WT_s[(i % E) * E + i / E] = v;
  }
}

// Add v into *dst, or store it on the block's first tile.
__device__ __forceinline__ void accumulate(float* dst, float v, bool first) {
  *dst = first ? v : *dst + v;
}

template <typename T, bool EACH>
__global__ void __launch_bounds__(kThreads)
interaction_bwd_kernel(const float* __restrict__ g, const T* __restrict__ x,
                       const float* __restrict__ w1, const float* __restrict__ b1,
                       const float* __restrict__ w2, const float* __restrict__ b2,
                       const T* __restrict__ wbi, T* __restrict__ dx,
                       float* __restrict__ part, int B, int F, int E, int R, int TB,
                       int part_stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdLayout L = bwd_layout<T>(TB, F, E, R);
  T* x_s = reinterpret_cast<T*>(smem + L.x);
  float* ds_s = reinterpret_cast<float*>(smem + L.ds);
  T* dvc_s = reinterpret_cast<T*>(smem + L.dvc);
  T* W_s = reinterpret_cast<T*>(smem + L.w);
  T* WT_s = reinterpret_cast<T*>(smem + L.wt);
  float* z_s = reinterpret_cast<float*>(smem + L.small);  // (TB, F)
  float* w_s = z_s + TB * F;                               // (TB, F)
  float* dh2_s = w_s + TB * F;                             // (TB, F)
  float* dz_s = dh2_s + TB * F;                            // (TB, F)
  float* h1_s = dz_s + TB * F;                             // (TB, R)
  float* dh1_s = h1_s + TB * R;                            // (TB, R)

  const int P = F * (F - 1) / 2;
  const int FE = F * E;
  const size_t g_stride = static_cast<size_t>(F + P) * E;
  const size_t ee = static_cast<size_t>(E) * E;
  const int nq = EACH ? F - 1 : 1;
  const int n_tiles = (B + TB - 1) / TB;
  const int e4n = E / 4;
  const int vtiles = (TB / 4) * e4n;
  const int nvec4 = E * E / 4;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  // this block's partial: [dW_bi (nq,E,E) | dW1 (F,R) | db1 (R) | dW2 (R,F) | db2 (F)]
  float* my_part = part + static_cast<size_t>(blockIdx.x) * part_stride;
  float* gate_part = my_part + nq * ee;
  const int n_gate = 2 * F * R + R + F;

  if (!EACH) {
    load_weight(W_s, WT_s, wbi, E);
    __syncthreads();
  }

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const bool first = tile == static_cast<int>(blockIdx.x);
    const int row0 = tile * TB;

    // ---- x tile, and ds initialised with g's S columns ----
    load_rows(x_s, x, row0, TB, B, FE);
    for (int i = threadIdx.x; i < TB * FE / 4; i += blockDim.x) {
      const int e4 = i * 4;
      const int r = e4 / FE, col = e4 % FE;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < B) {
        v = *reinterpret_cast<const float4*>(g + static_cast<size_t>(row0 + r) * g_stride + col);
      }
      *reinterpret_cast<float4*>(ds_s + e4) = v;
    }
    __syncthreads();

    // ---- gate forward, fp32 ----
    for (int rf = warp; rf < TB * F; rf += nwarps) {
      const T* row = x_s + static_cast<size_t>(rf) * E;
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
      h1_s[i] = acc + b1[k];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < TB * F; i += blockDim.x) {
      const int r = i / F, f = i % F;
      float acc = 0.f;
      for (int k = 0; k < R; ++k) acc += fmaxf(h1_s[r * R + k], 0.f) * w2[k * F + f];
      w_s[i] = 1.f / (1.f + expf(-(acc + b2[f])));
    }
    __syncthreads();

    // ---- pairs and projections, one projected field at a time ----
    float4 dw[kMaxVec];
#pragma unroll
    for (int n = 0; n < kMaxVec; ++n) dw[n] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < F - 1; ++q) {
      const int p = EACH ? q : q + 1;  // "all" never needs v_0 (dv_0 = 0)
      if (EACH) {
        load_weight(W_s, WT_s, wbi + static_cast<size_t>(q) * ee, E);
        __syncthreads();
      }
      // (a) v_p tile in registers; every pair that uses it
      for (int t = threadIdx.x; t < vtiles; t += blockDim.x) {
        const int r0 = (t / e4n) * 4, c0 = (t % e4n) * 4;
        float v[4][4], dv[4][4], sp[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sp[i] = w_s[(r0 + i) * F + p];
#pragma unroll
          for (int j = 0; j < 4; ++j) v[i][j] = dv[i][j] = 0.f;
        }
        for (int k = 0; k < E; ++k) {
          float wk[4];
          load4(wk, W_s + static_cast<size_t>(k) * E + c0);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float s = rnd<T>(to_f(x_s[(static_cast<size_t>(r0 + i) * F + p) * E + k]) * sp[i]);
#pragma unroll
            for (int j = 0; j < 4; ++j) v[i][j] += s * wk[j];
          }
        }
        const int lo = EACH ? p + 1 : 0;
        const int hi = EACH ? F : p;
        for (int o = lo; o < hi; ++o) {
          const int pi = EACH ? p : o;
          const int pj = EACH ? o : p;
          const int k = pi * (2 * F - pi - 1) / 2 + (pj - pi - 1);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = r0 + i;
            if (row0 + r >= B) continue;
            float gk[4], xo[4];
            load4(gk, g + static_cast<size_t>(row0 + r) * g_stride +
                          static_cast<size_t>(F + k) * E + c0);
            const size_t off = (static_cast<size_t>(r) * F + o) * E + c0;
            load4(xo, x_s + off);
            const float wo = w_s[r * F + o];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              dv[i][j] += gk[j] * (xo[j] * wo);
              ds_s[off + j] += gk[j] * v[i][j];
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) store4(dvc_s + static_cast<size_t>(r0 + i) * E + c0, dv[i]);
      }
      __syncthreads();
      // (b) ds_p += cd(dv_p) cd(W)^T, same tile ownership as (a)
      for (int t = threadIdx.x; t < vtiles; t += blockDim.x) {
        const int r0 = (t / e4n) * 4, c0 = (t % e4n) * 4;
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        for (int d = 0; d < E; ++d) {
          float wt[4];
          load4(wt, WT_s + static_cast<size_t>(d) * E + c0);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float dvv = to_f(dvc_s[static_cast<size_t>(r0 + i) * E + d]);
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += dvv * wt[j];
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* dsp = ds_s + (static_cast<size_t>(r0 + i) * F + p) * E + c0;
#pragma unroll
          for (int j = 0; j < 4; ++j) dsp[j] += acc[i][j];
        }
      }
      // (b') dW_p += cd(s_p)^T cd(dv_p), summed over the tile's rows
#pragma unroll
      for (int n = 0; n < kMaxVec; ++n) {
        const int i4 = threadIdx.x + n * blockDim.x;
        if (i4 < nvec4) {
          const int k = (i4 * 4) / E, c = (i4 * 4) % E;
          float a4[4] = {dw[n].x, dw[n].y, dw[n].z, dw[n].w};
          for (int r = 0; r < TB; ++r) {
            const float sc = rnd<T>(to_f(x_s[(static_cast<size_t>(r) * F + p) * E + k]) *
                                    w_s[r * F + p]);
            float d4[4];
            load4(d4, dvc_s + static_cast<size_t>(r) * E + c);
#pragma unroll
            for (int j = 0; j < 4; ++j) a4[j] += sc * d4[j];
          }
          dw[n] = make_float4(a4[0], a4[1], a4[2], a4[3]);
        }
      }
      if (EACH || q == F - 2) {  // flush this matrix's tile sum into the partial
        float4* dst = reinterpret_cast<float4*>(my_part + (EACH ? q : 0) * ee);
#pragma unroll
        for (int n = 0; n < kMaxVec; ++n) {
          const int i4 = threadIdx.x + n * blockDim.x;
          if (i4 < nvec4) {
            float4 o = first ? make_float4(0.f, 0.f, 0.f, 0.f) : dst[i4];
            o.x += dw[n].x;
            o.y += dw[n].y;
            o.z += dw[n].z;
            o.w += dw[n].w;
            dst[i4] = o;
          }
          dw[n] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
      __syncthreads();  // dvc_s (and, for "each", W) are rewritten next
    }

    // ---- gate backward, fp32 ----
    for (int rf = warp; rf < TB * F; rf += nwarps) {
      const T* row = x_s + static_cast<size_t>(rf) * E;
      const float* drow = ds_s + static_cast<size_t>(rf) * E;
      float acc = 0.f;
      for (int c = lane; c < E; c += 32) acc += drow[c] * to_f(row[c]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) {
        const float wv = w_s[rf];
        dh2_s[rf] = acc * wv * (1.f - wv);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < TB * R; i += blockDim.x) {
      const int r = i / R, k = i % R;
      float da = 0.f;
      for (int f = 0; f < F; ++f) da += dh2_s[r * F + f] * w2[k * F + f];
      dh1_s[i] = h1_s[i] > 0.f ? da : 0.f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < TB * F; i += blockDim.x) {
      const int r = i / F, f = i % F;
      float acc = 0.f;
      for (int k = 0; k < R; ++k) acc += dh1_s[r * R + k] * w1[f * R + k];
      dz_s[i] = acc;
    }
    for (int j = threadIdx.x; j < n_gate; j += blockDim.x) {
      float acc = 0.f;
      if (j < F * R) {  // dW1[f, k] = sum_r z[r, f] dh1[r, k]
        const int f = j / R, k = j % R;
        for (int r = 0; r < TB; ++r) acc += z_s[r * F + f] * dh1_s[r * R + k];
      } else if (j < F * R + R) {  // db1[k]
        const int k = j - F * R;
        for (int r = 0; r < TB; ++r) acc += dh1_s[r * R + k];
      } else if (j < 2 * F * R + R) {  // dW2[k, f] = sum_r a[r, k] dh2[r, f]
        const int kf = j - F * R - R;
        const int k = kf / F, f = kf % F;
        for (int r = 0; r < TB; ++r) acc += fmaxf(h1_s[r * R + k], 0.f) * dh2_s[r * F + f];
      } else {  // db2[f]
        const int f = j - 2 * F * R - R;
        for (int r = 0; r < TB; ++r) acc += dh2_s[r * F + f];
      }
      accumulate(gate_part + j, acc, first);
    }
    __syncthreads();

    // ---- dx = ds * w + dz / E, in T ----
    const float inv_e = 1.f / static_cast<float>(E);
    for (int i = threadIdx.x; i < TB * FE / 4; i += blockDim.x) {
      const int e4 = i * 4;
      const int r = e4 / FE, col = e4 % FE;
      if (row0 + r >= B) continue;
      const int rf = r * F + col / E;
      const float wv = w_s[rf], dzv = dz_s[rf] * inv_e;
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = ds_s[e4 + j] * wv + dzv;
      store4(dx + static_cast<size_t>(row0 + r) * FE + col, o);
    }
    __syncthreads();  // x_s and ds_s are reloaded for the next tile
  }
}

// out[j] = sum over blocks c = 0..G-1, in that order, of part[c][j]
__global__ void __launch_bounds__(kThreads)
reduce_partials(const float* __restrict__ part, float* __restrict__ out, int G, int stride,
                int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  float acc = 0.f;
  for (int c = 0; c < G; ++c) acc += part[static_cast<size_t>(c) * stride + j];
  out[j] = acc;
}

template <typename T, bool EACH>
static int launch(const float* g, const void* x, const float* w1, const float* b1,
                  const float* w2, const float* b2, const void* wbi, void* dx, float* part,
                  float* out, int B, int F, int E, int R, int grid, int part_stride,
                  cudaStream_t stream) {
  const int tb = tile_rows<T>(F, E, R);
  const int nq = EACH ? F - 1 : 1;
  const int n = nq * E * E + 2 * F * R + R + F;
  if (tb < 4 || E > kMaxE || E % 8 || F < 2 || B < 1 || grid < 1 ||
      grid > (B + tb - 1) / tb || part_stride < n || part_stride % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = bwd_layout<T>(tb, F, E, R).total;
  auto kern = interaction_bwd_kernel<T, EACH>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, kThreads, smem, stream>>>(
      g, static_cast<const T*>(x), w1, b1, w2, b2, static_cast<const T*>(wbi),
      static_cast<T*>(dx), part, B, F, E, R, tb, part_stride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(part, out, grid,
                                                                          part_stride, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ctr

// Rows per block tile for these sizes (0: the tile does not fit a block).
extern "C" int interaction_bwd_tile_rows(int F, int E, int R, int is_bf16) {
  return is_bf16 ? ctr::tile_rows<__nv_bfloat16>(F, E, R) : ctr::tile_rows<float>(F, E, R);
}

// g (B, (F + F(F-1)/2) * E) fp32; x (B, F*E) and wbi ((E, E) or (F-1, E, E))
// in the compute dtype (bf16 when is_bf16, else fp32); SENet weights fp32.
// Writes dx (B, F*E) in the compute dtype and, through `grid` per-block
// partials of part_stride floats each, out = [dW_bi | dW1 | db1 | dW2 | db2]
// fp32. Two launches (the kernel, then the reduction). Requires E % 8 == 0,
// E <= 128 and 16-byte aligned pointers. Returns a cudaError_t.
extern "C" int interaction_bwd(const float* g, const void* x, const float* w1,
                               const float* b1, const float* w2, const float* b2,
                               const void* wbi, void* dx, float* part, float* out, int B,
                               int F, int E, int R, int is_bf16, int each, int grid,
                               int part_stride, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return each ? ctr::launch<__nv_bfloat16, true>(g, x, w1, b1, w2, b2, wbi, dx, part, out, B,
                                                   F, E, R, grid, part_stride, s)
                : ctr::launch<__nv_bfloat16, false>(g, x, w1, b1, w2, b2, wbi, dx, part, out,
                                                    B, F, E, R, grid, part_stride, s);
  }
  return each ? ctr::launch<float, true>(g, x, w1, b1, w2, b2, wbi, dx, part, out, B, F, E, R,
                                         grid, part_stride, s)
              : ctr::launch<float, false>(g, x, w1, b1, w2, b2, wbi, dx, part, out, B, F, E, R,
                                          grid, part_stride, s);
}
