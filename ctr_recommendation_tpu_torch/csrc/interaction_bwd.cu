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
// g (44.0 MB fp32) and x (6.3 MB) and write dx (6.3 MB); the 2.0 GFLOP of
// projections are far below the card's compute line (E=256: 113 MB against
// 8.1 GFLOP, still bytes).
//
// Design. A block of 256 threads owns TB rows at a time and keeps x, the
// fp32 ds accumulator, a (TB, E) buffer for dv, the projection weight (in T)
// and the small gate vectors in shared memory. g is streamed from device
// memory once, one E-wide chunk per field or pair, as 16-byte loads. For
// each projected field p, a thread computes a 4x4 tile of v_p in registers,
// walks every pair that uses v_p, adds into ds in shared memory and
// accumulates the matching 4x4 tile of dv_p in registers; dv_p is complete
// at that point (each pair's dv goes to exactly one projected field), so it
// is rounded into the dv buffer and its two products run at once. The
// weight gradients are summed over the batch without atomics: the grid is
// persistent (at most one block per SM, each looping over row tiles in a
// fixed order) and each block adds into its own fp32 partial in device
// memory; a second launch reduces the partials in block order. Two launches
// on the same inputs are therefore bit-identical. Rows past B are
// zero-filled in shared memory, read no g and write no dx, so they add
// exactly zero. The products run as fp32 FMA on the CUDA cores: simple first.
//
// Any E % 8 == 0 that leaves a row tile of 4 in shared memory (E=256 in both
// dtypes). Two plans:
//   blocked: W and W^T (128 KB each in bf16 at E=256) do not both fit beside
//     x and ds, so one (E, nc + 4) buffer holds a column block of W while v_p
//     is formed (the v tiles walk the blocks) and then a column block of W^T
//     (a row block of W, transposed on the way in; the 4-element pad spreads
//     its banks) while ds_p += cd(dv_p) W^T is. Both are restaged from L2
//     for every field of every tile. (TB, nc) maximises the 4x4 tiles of a
//     block: at E=128 TB=32, nc=128 in bf16 (24, 128 in fp32); at E=256
//     TB=16, nc=128 in bf16 and TB=12, nc=64 in fp32.
//   resident, "all" only: W and W^T whole in T, loaded once a call, when a
//     tile of 8 rows or more fits beside them (E=128: TB=32 in bf16, 12 in
//     fp32). On an H100 (bf16, B=4096, E=128; chip_smoke.py's timing of the
//     earlier kernel, which staged W whole for both types, and of the blocked
//     plan in turns on one card) "all" took 0.34-0.37 ms with W whole and
//     0.38-0.44 ms blocked; "each", which needs a new W every field anyway,
//     0.45-0.46 ms with whole-W loads and 0.37-0.39 ms blocked.
// dW_bi accumulates in registers, 16 float4 a thread: a whole 128 x 128
// matrix, which for "all" is held across the fields of a tile and flushed
// into the partial once. A wider E takes the same accumulator in passes over
// the matrix's elements (E^2/4/256 float4 a thread, 64 at E=256, is more than
// a thread's 255 registers), each pass flushed into the partial as soon as it
// has summed the tile's rows for one field. The flush order is fixed, so
// repeats stay bit-identical. The flushes are what the passes cost: at E=256
// each tile reads and rewrites its block's 256 KB partial of a matrix once a
// field, 5 x 2 x 256 KB a tile, ~650 MB a call over B=4096's 256 tiles. For
// "all" that is one 256 KB partial a block, which L2 holds; for "each" five,
// 1.3 MB a block, which it does not. A second kernel forming dW_bi from a
// scratch of cd(s_p) and cd(dv_p) would move 2(F-1)E values a row each way
// instead, 21 MB at B=4096 in bf16. Passes were taken to keep one launch
// pair and the partials' reduction as they were; which design is faster was
// not measured.

#include "common.cuh"

namespace ctr {

constexpr int kMaxVec = 16;  // dW_bi accumulator: float4 a thread (a 128 x 128 matrix)
constexpr int kVecPass = kMaxVec * kThreads;

struct BwdPlan {
  int tb, nc, resident;
};

struct BwdLayout {
  size_t x, ds, dvc, w, wt, small, total;
};

// Leading dimension of the staged weight: E when resident, nc + 4 blocked.
__host__ __device__ inline int weight_ld(const BwdPlan& P, int E) {
  return P.resident ? E : P.nc + 4;
}

// Shared memory of one block: x (TB,F,E) in T, ds (TB,F,E) fp32, dvc (TB,E)
// in T, then W and W^T (E,E) in T (resident) or one (E, nc + 4) block of W
// or W^T in T (blocked), then z, w, dh2, dz (TB,F) and h1, dh1 (TB,R).
template <typename T>
__host__ __device__ inline BwdLayout bwd_layout(const BwdPlan& P, int F, int E, int R) {
  BwdLayout L;
  const int TB = P.tb;
  size_t o = 0;
  L.x = o;
  o += align16(static_cast<size_t>(TB) * F * E * sizeof(T));
  L.ds = o;
  o += align16(static_cast<size_t>(TB) * F * E * sizeof(float));
  L.dvc = o;
  o += align16(static_cast<size_t>(TB) * E * sizeof(T));
  L.w = o;
  o += align16(static_cast<size_t>(E) * weight_ld(P, E) * sizeof(T));
  L.wt = P.resident ? o : L.w;
  if (P.resident) o += align16(static_cast<size_t>(E) * E * sizeof(T));
  L.small = o;
  o += static_cast<size_t>(TB) * (4 * F + 2 * R) * sizeof(float);
  L.total = o;
  return L;
}

// For "all", the resident plan with the most rows, if one of 8 or more
// fits; else the blocked plan with the most 4x4 tiles a block (TB * nc),
// larger TB first.
template <typename T>
static BwdPlan bwd_plan(int F, int E, int R, bool each) {
  for (int tb = 32; tb >= 8 && !each; tb -= 4) {
    const BwdPlan P{tb, E, 1};
    if (bwd_layout<T>(P, F, E, R).total <= kMaxSmem) return P;
  }
  BwdPlan best{0, 0, 0};
  for (int tb = 32; tb >= 4; tb -= 4) {
    for (int nc = E; nc >= 8; nc -= 8) {
      const BwdPlan P{tb, nc, 0};
      if (E % nc || bwd_layout<T>(P, F, E, R).total > kMaxSmem) continue;
      if (tb * nc > best.tb * best.nc) best = P;
      break;
    }
  }
  return best;
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

// Columns [cb, cb + nc) of W (E,E) into W_s (E, ld), ld = nc + 4: 16-byte
// loads along W's rows (each thread a different piece), 8-byte stores.
template <typename T>
__device__ __forceinline__ void load_weight_cols(T* W_s, const T* __restrict__ w, int E, int cb,
                                                 int nc, int ld) {
  constexpr int V = 16 / sizeof(T);  // elements a 16-byte load
  const int nv = nc / V;
  const int dk = blockDim.x / nv, dg = blockDim.x % nv;
  int k = threadIdx.x / nv, g = threadIdx.x % nv;  // as load_cols_f32 walks
  while (k < E) {
    const uint4 u = *reinterpret_cast<const uint4*>(w + static_cast<size_t>(k) * E + cb + g * V);
    uint2* d = reinterpret_cast<uint2*>(W_s + static_cast<size_t>(k) * ld + g * V);
    d[0] = make_uint2(u.x, u.y);
    d[1] = make_uint2(u.z, u.w);
    k += dk;
    g += dg;
    if (g >= nv) {
      g -= nv;
      ++k;
    }
  }
}

// Columns [cb, cb + nc) of W^T, i.e. rows cb.. of W, into WT_s (E, ld):
// WT_s[d][j] = W[cb + j][d]. Neighbouring threads take neighbouring rows j
// (16 bytes of each), so their shared-memory stores land side by side.
template <typename T>
__device__ __forceinline__ void load_weight_t_cols(T* WT_s, const T* __restrict__ w, int E,
                                                   int cb, int nc, int ld) {
  constexpr int V = 16 / sizeof(T);
  const int dd = blockDim.x / nc, dj = blockDim.x % nc;
  int d = threadIdx.x / nc, j = threadIdx.x % nc;  // d counts V-element pieces
  while (d < E / V) {
    const uint4 u =
        *reinterpret_cast<const uint4*>(w + static_cast<size_t>(cb + j) * E + d * V);
    const T* h = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int v = 0; v < V; ++v) WT_s[static_cast<size_t>(d * V + v) * ld + j] = h[v];
    d += dd;
    j += dj;
    if (j >= nc) {
      j -= nc;
      ++d;
    }
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
                       float* __restrict__ part, int B, int F, int E, int R, BwdPlan plan,
                       int part_stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdLayout L = bwd_layout<T>(plan, F, E, R);
  const int TB = plan.tb;
  T* x_s = reinterpret_cast<T*>(smem + L.x);
  float* ds_s = reinterpret_cast<float*>(smem + L.ds);
  T* dvc_s = reinterpret_cast<T*>(smem + L.dvc);
  T* W_s = reinterpret_cast<T*>(smem + L.w);    // W, or a column block of it
  T* WT_s = reinterpret_cast<T*>(smem + L.wt);  // W^T, or a column block of it (blocked: = W_s)
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
  const bool resident = plan.resident != 0;  // "all" only
  const int nc = plan.nc, ldw = weight_ld(plan, E);
  const int n4 = nc / 4;
  const int vtiles = (TB / 4) * n4;  // 4x4 tiles of one column block
  const int nvec4 = E * E / 4;
  const int npass = (nvec4 + kVecPass - 1) / kVecPass;  // dW_bi accumulator passes
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  // this block's partial: [dW_bi (nq,E,E) | dW1 (F,R) | db1 (R) | dW2 (R,F) | db2 (F)]
  float* my_part = part + static_cast<size_t>(blockIdx.x) * part_stride;
  float* gate_part = my_part + nq * ee;
  const int n_gate = 2 * F * R + R + F;

  if (resident) {
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
      const T* wq = wbi + (EACH ? static_cast<size_t>(q) * ee : 0);
      // (a) v_p tile in registers; every pair that uses it; W a column block at a time
      for (int cb = 0; cb < E; cb += nc) {
        if (!resident) {
          __syncthreads();  // every reader of the previous block is done
          load_weight_cols(W_s, wq, E, cb, nc, ldw);
          __syncthreads();
        }
        for (int t = threadIdx.x; t < vtiles; t += blockDim.x) {
          const int r0 = (t / n4) * 4, cl = (t % n4) * 4, c0 = cb + cl;
          float v[4][4], dv[4][4], sp[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            sp[i] = w_s[(r0 + i) * F + p];
#pragma unroll
            for (int j = 0; j < 4; ++j) v[i][j] = dv[i][j] = 0.f;
          }
          for (int k = 0; k < E; ++k) {
            float wk[4];
            load4(wk, W_s + static_cast<size_t>(k) * ldw + cl);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float s =
                  rnd<T>(to_f(x_s[(static_cast<size_t>(r0 + i) * F + p) * E + k]) * sp[i]);
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
          for (int i = 0; i < 4; ++i)
            store4(dvc_s + static_cast<size_t>(r0 + i) * E + c0, dv[i]);
        }
      }
      __syncthreads();
      // (b) ds_p += cd(dv_p) cd(W)^T, a column block of W^T at a time
      for (int cb = 0; cb < E; cb += nc) {
        if (!resident) {
          __syncthreads();
          load_weight_t_cols(WT_s, wq, E, cb, nc, ldw);
          __syncthreads();
        }
        for (int t = threadIdx.x; t < vtiles; t += blockDim.x) {
          const int r0 = (t / n4) * 4, cl = (t % n4) * 4, c0 = cb + cl;
          float acc[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
          for (int d = 0; d < E; ++d) {
            float wt[4];
            load4(wt, WT_s + static_cast<size_t>(d) * ldw + cl);
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
      }
      // (b') dW_p += cd(s_p)^T cd(dv_p), summed over the tile's rows, in
      // passes of kVecPass float4 (one pass up to E=128)
      for (int ps = 0; ps < npass; ++ps) {
        const int base = ps * kVecPass;
#pragma unroll
        for (int n = 0; n < kMaxVec; ++n) {
          const int i4 = base + threadIdx.x + n * blockDim.x;
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
        // flush into the partial: a whole matrix's tile sum at its last field
        // (one pass), or this pass's share at every field (several passes)
        if (EACH || npass > 1 || q == F - 2) {
          const bool fresh = first && (EACH || npass == 1 || q == 0);
          float4* dst = reinterpret_cast<float4*>(my_part + (EACH ? q : 0) * ee);
#pragma unroll
          for (int n = 0; n < kMaxVec; ++n) {
            const int i4 = base + threadIdx.x + n * blockDim.x;
            if (i4 < nvec4) {
              float4 o = fresh ? make_float4(0.f, 0.f, 0.f, 0.f) : dst[i4];
              o.x += dw[n].x;
              o.y += dw[n].y;
              o.z += dw[n].z;
              o.w += dw[n].w;
              dst[i4] = o;
            }
            dw[n] = make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
      }
      __syncthreads();  // dvc_s (and, blocked, W_s) are rewritten next
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
  const BwdPlan plan = bwd_plan<T>(F, E, R, EACH);
  const int tb = plan.tb;
  const int nq = EACH ? F - 1 : 1;
  const int n = nq * E * E + 2 * F * R + R + F;
  if (tb < 4 || E % 8 || F < 2 || B < 1 || grid < 1 || grid > (B + tb - 1) / tb ||
      part_stride < n || part_stride % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = bwd_layout<T>(plan, F, E, R).total;
  auto kern = interaction_bwd_kernel<T, EACH>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, kThreads, smem, stream>>>(
      g, static_cast<const T*>(x), w1, b1, w2, b2, static_cast<const T*>(wbi),
      static_cast<T*>(dx), part, B, F, E, R, plan, part_stride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(part, out, grid,
                                                                          part_stride, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ctr

// Rows per block tile for these sizes (0: no tile of 4 rows fits a block).
extern "C" int interaction_bwd_tile_rows(int F, int E, int R, int is_bf16, int each) {
  return is_bf16 ? ctr::bwd_plan<__nv_bfloat16>(F, E, R, each).tb
                 : ctr::bwd_plan<float>(F, E, R, each).tb;
}

// g (B, (F + F(F-1)/2) * E) fp32; x (B, F*E) and wbi ((E, E) or (F-1, E, E))
// in the compute dtype (bf16 when is_bf16, else fp32); SENet weights fp32.
// Writes dx (B, F*E) in the compute dtype and, through `grid` per-block
// partials of part_stride floats each, out = [dW_bi | dW1 | db1 | dW2 | db2]
// fp32. Two launches (the kernel, then the reduction). Requires F >= 2,
// E % 8 == 0, a row tile that fits a block (interaction_bwd_tile_rows) and
// 16-byte aligned pointers. Returns a cudaError_t.
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
