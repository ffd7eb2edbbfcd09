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
// The projected fields p are 1..F-1 for "all" (v_0 is never used) and
// 0..F-2 for "each": Q = F - 1 of them.
//
// Bound on an H100: bytes. At B=4096, F=6, E=128 with bf16 x it must read
// g (44.0 MB fp32) and x (6.3 MB) and write dx (6.3 MB), ~57 MB or 17 us at
// 3.35 TB/s; the 2.0 GFLOP of E x E products (8.1 at E=256, against 113
// MB) are far below the tensor cores' line.
//
// Design: seven launches on one stream, each a building block with its own
// C entry point (bound alone below for the checks on the card) and plain
// PyTorch version (ops/cuda/interaction.py). Scratch is field-major, so the
// Q projected fields of a batch form one contiguous (Q B, E) matrix and
// each field one contiguous (B, E) slice:
//
//   1. gate: one warp a row; z, h1, w (fp32, (B,F), (B,R), (B,F)) and
//      sc = cd(x_p w_p) (Q, B, E) in T: the forward's gate of
//      interaction.cuh, instantiated at this kernel's rounding point;
//   2. V = sc W: the tile product of tile_mma.cuh ("nn"; "all" one product
//      with M = Q B, "each" Q groups of M = B, one launch), fp32 out;
//   3. pairs: an elementwise pass, a thread four columns of a row (its ds
//      and s in registers for F <= 8, ds summed in place beyond); streams
//      g once as 16-byte loads and writes ds (B, F, E) fp32 (g's S columns
//      plus each pair's term, in pair order) and dvc = cd(dv_p) (Q, B, E);
//   4. the projection term P = dvc W^T: the tile product "nt" (W read as
//      stored), fp32 (Q, B, E) into V's scratch, which block 3 has read;
//   5. gate backward and dx: one warp a row over fixed row chunks, ds_p =
//      ds_p + P_p read on the fly, dh2 (B, F) and dh1 (B, R) to scratch,
//      dx = cd(ds w + dz / E); then one fp32 partial a block of
//      [dW1|db1|dW2|db2], each entry its chunk's rows summed in order;
//   6. dW_bi = sc^T dvc: the tile product "tn" with K = the rows ("all" one
//      product over Q B rows, which sums the fields; "each" Q groups of B),
//      K split into chunks so that ~132 blocks run, one fp32 partial each;
//   7. one reduction of both kinds of partial, each output a fixed-order
//      sum: two launches on the same inputs are bit-identical.
//
// bf16 products run on the tensor cores (ldmatrix / mma.sync, fp32
// accumulators); fp32 ones on the CUDA cores with fp64 accumulators. The
// sequence moves ~185 MB at B=4096, E=128 (~370 MB at E=256); the wrapper
// allocates one workspace for the scratch and picks the split layouts
// (chunk sizes); the kernels allocate nothing. Rows past B are never read or stored.
//
// Envelope: F >= 2, E % 8 == 0 (16-byte rows and staged pieces of the
// products), any B. The pairs pass and the gate backward keep a row's
// fields in registers for 2 <= F <= 8 (one instantiation a field count)
// and sum in their outputs beyond.

#include "interaction.cuh"

namespace ctr {
namespace ibwd {

// ---- block 3: the pairs' backward, g streamed once ----
// Thread (row b, columns c..c+3). ds (B, F, E) fp32, dvc (Q, B, E) in T;
// V (Q, B, E) fp32; w (B, F) fp32. For each projected field d (q
// ascending) dv_d is summed in a register over its pairs' other fields o,
// and each ds_o gains g_k v_d: "all" p_k = s_o v_d (o < d = q + 1), "each"
// p_k = v_d s_o (o > d = q). So ds_o is g_o plus its pairs' terms in pair
// order, and dv_d its terms in pair order. NF > 0: F = NF, the row's ds
// and s in registers; NF = 0: any F, ds summed in place in its output and
// s recomputed from x.
template <typename T, bool EACH, int NF>
__global__ void __launch_bounds__(kThreads)
pairs_bwd(const float* __restrict__ g, const T* __restrict__ x, const float* __restrict__ w,
          const float* __restrict__ V, float* __restrict__ ds, T* __restrict__ dvc, int B, int F_,
          int E) {
  const int F = NF > 0 ? NF : F_;
  const int e4 = E / 4;
  const size_t t = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
  const int b = static_cast<int>(t / e4);
  if (b >= B) return;
  const int c = static_cast<int>(t % e4) * 4;
  const float* gr = g + static_cast<size_t>(b) * (F + F * (F - 1) / 2) * E + c;
  const T* xr = x + static_cast<size_t>(b) * F * E + c;
  const float* wr = w + static_cast<size_t>(b) * F;
  float* dsr = ds + static_cast<size_t>(b) * F * E + c;
  float4 acc[NF > 0 ? NF : 1], s[NF > 0 ? NF : 1];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    if constexpr (NF > 0) {
      acc[f] = load4(gr + f * E);
      s[f] = scale4(load4(xr + f * E), wr[f]);
    } else {
      store4(dsr + f * E, load4(gr + f * E));
    }
  }
#pragma unroll
  for (int q = 0; q < F - 1; ++q) {
    const int d = EACH ? q : q + 1;
    const float4 v = load4(V + (static_cast<size_t>(q) * B + b) * E + c);
    float4 dv = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int o = EACH ? d + 1 : 0; o < (EACH ? F : d); ++o) {
      const float4 gk = load4(gr + (F + (EACH ? pair_of(d, o, F) : pair_of(o, d, F))) * E);
      if constexpr (NF > 0) {
        fma4(dv, gk, s[o]);
        fma4(acc[o], gk, v);
      } else {
        fma4(dv, gk, scale4(load4(xr + o * E), wr[o]));
        float4 a = load4(dsr + o * E);
        fma4(a, gk, v);
        store4(dsr + o * E, a);
      }
    }
    store4(dvc + (static_cast<size_t>(q) * B + b) * E + c, dv);
  }
  if constexpr (NF > 0) {
#pragma unroll
    for (int f = 0; f < F; ++f) store4(dsr + f * E, acc[f]);
  }
}

// ---- block 5: the gate's backward and dx, per-block gate partials ----
// ds (B, F, E) from block 3 plus, at projected field p = q + poff, the
// projection term P (Q, B, E) of block 4. Block k takes rows [k chunk,
// min(B, (k + 1) chunk)), one warp a row: dh2 (B, F) and dh1 (B, R) go to
// their scratch, then dx. The block then writes its partial part
// (gridDim.x, n_gate) fp32, n_gate = 2 F R + R + F in the order [dW1 (F,R)
// | db1 (R) | dW2 (R,F) | db2 (F)], each entry one thread summing its rows
// in order. NF > 0: F = NF, the row's gate in registers and ds + P at its
// first column step a field kept for dx (all of it at E <= 128); NF = 0:
// any F, dh2 and dh1 read back from their scratch after __syncwarp and
// ds + P read again for dx.
template <typename T, int NF>
__global__ void __launch_bounds__(kThreads)
gate_bwd(const float* __restrict__ ds, const float* __restrict__ P, const T* __restrict__ x,
         const float* __restrict__ z, const float* __restrict__ h1, const float* __restrict__ w,
         const float* __restrict__ w1, const float* __restrict__ w2, T* __restrict__ dx,
         float* dh2, float* dh1, float* __restrict__ part, int B, int F_, int E, int R, int chunk,
         int poff) {
  const int F = NF > 0 ? NF : F_;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * chunk, r_end = min(B, r0 + chunk);
  const float inv_e = 1.f / static_cast<float>(E);
  for (int row = r0 + warp; row < r_end; row += kRowsPerBlock) {
    const size_t base = static_cast<size_t>(row) * F * E;
    const float* wr = w + static_cast<size_t>(row) * F;
    const float* hr = h1 + static_cast<size_t>(row) * R;
    float* d2 = dh2 + static_cast<size_t>(row) * F;
    float* d1 = dh1 + static_cast<size_t>(row) * R;
    auto ds_at = [&](int f, int c) {  // ds + P at a projected field
      float4 a = load4(ds + base + f * E + c);
      const int q = f - poff;
      if (q >= 0 && q < F - 1) {
        const float4 t = load4(P + (static_cast<size_t>(q) * B + row) * E + c);
        a = make_float4(a.x + t.x, a.y + t.y, a.z + t.z, a.w + t.w);
      }
      return a;
    };
    auto dot = [&](int f, int c, float4 a) {  // (ds + P) . x at a column step
      const float4 xv = load4(x + base + f * E + c);
      return a.x * xv.x + a.y * xv.y + a.z * xv.z + a.w * xv.w;
    };
    auto put_dx = [&](int f, int c, float4 a, float dzv) {
      const float wf = wr[f];
      store4(dx + base + f * E + c,
             make_float4(a.x * wf + dzv, a.y * wf + dzv, a.z * wf + dzv, a.w * wf + dzv));
    };
    if constexpr (NF > 0) {
      // the row in registers, every lane holding the whole gate; a column
      // step's loads of every field in flight together, and ds + P at the
      // first step kept for dx
      const int c0 = lane * 4;
      float d[NF], dz[NF];
      float4 keep[NF];
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        d[f] = dz[f] = 0.f;
        if (c0 < E) {
          keep[f] = ds_at(f, c0);
          d[f] = dot(f, c0, keep[f]);
        }
      }
      for (int c = c0 + 128; c < E; c += 128) {
#pragma unroll
        for (int f = 0; f < NF; ++f) d[f] += dot(f, c, ds_at(f, c));
      }
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        d[f] = warp_sum(d[f]) * wr[f] * (1.f - wr[f]);  // dh2
        if (lane == f % 32) d2[f] = d[f];
      }
      for (int k = 0; k < R; ++k) {
        float da = 0.f;
#pragma unroll
        for (int f = 0; f < NF; ++f) da += d[f] * w2[k * NF + f];
        const float dh = hr[k] > 0.f ? da : 0.f;
        if (lane == k % 32) d1[k] = dh;
#pragma unroll
        for (int f = 0; f < NF; ++f) dz[f] += dh * w1[f * R + k];
      }
      if (c0 < E) {
#pragma unroll
        for (int f = 0; f < NF; ++f) put_dx(f, c0, keep[f], dz[f] * inv_e);
      }
      for (int c = c0 + 128; c < E; c += 128) {
#pragma unroll
        for (int f = 0; f < NF; ++f) put_dx(f, c, ds_at(f, c), dz[f] * inv_e);
      }
    } else {
      // any F: a field at a time, dh2 and dh1 through their scratch
      for (int f = 0; f < F; ++f) {
        float d = 0.f;
        for (int c = lane * 4; c < E; c += 128) d += dot(f, c, ds_at(f, c));
        d = warp_sum(d);
        if (lane == 0) d2[f] = d * wr[f] * (1.f - wr[f]);
      }
      __syncwarp();
      for (int k = lane; k < R; k += 32) {
        float da = 0.f;
        for (int f = 0; f < F; ++f) da += d2[f] * w2[k * F + f];
        d1[k] = hr[k] > 0.f ? da : 0.f;
      }
      __syncwarp();
      for (int f = 0; f < F; ++f) {
        float dz = 0.f;
        for (int k = 0; k < R; ++k) dz += d1[k] * w1[f * R + k];
        for (int c = lane * 4; c < E; c += 128) put_dx(f, c, ds_at(f, c), dz * inv_e);
      }
    }
  }
  __syncthreads();  // the block's rows of dh1 and dh2 are written
  const int n_gate = 2 * F * R + R + F;
  for (int j = threadIdx.x; j < n_gate; j += blockDim.x) {
    // entry j sums u[row] v[row] over the rows (u = 1 for a bias), each
    // operand a column of a (rows, F) or (rows, R) array
    const float *u = nullptr, *v;
    int su = 0, sv;
    if (j < F * R) {  // dW1[f, k] += z[f] dh1[k]
      u = z + j / R, su = F, v = dh1 + j % R, sv = R;
    } else if (j < F * R + R) {  // db1[k] += dh1[k]
      v = dh1 + (j - F * R), sv = R;
    } else if (j < 2 * F * R + R) {  // dW2[k, f] += relu(h1[k]) dh2[f]
      const int kf = j - F * R - R;
      u = h1 + kf / F, su = R, v = dh2 + kf % F, sv = F;
    } else {  // db2[f] += dh2[f]
      v = dh2 + (j - 2 * F * R - R), sv = F;
    }
    const bool relu = j >= F * R + R;  // u is h1: a = relu(h1)
    float acc = 0.f;
#pragma unroll 8
    for (int row = r0; row < r_end; ++row) {  // independent loads, summed in row order
      float t = v[static_cast<size_t>(row) * sv];
      if (u) {
        const float a = u[static_cast<size_t>(row) * su];
        t *= relu ? fmaxf(a, 0.f) : a;
      }
      acc += t;
    }
    part[static_cast<size_t>(blockIdx.x) * n_gate + j] = acc;
  }
}

// ---- block 7: the fixed-order reduction ----
// out[g EE + u] = sum over s < splits of pbi[(g splits + s) EE + u] for the
// G groups of dW_bi, then out[G EE + u] = sum over k < nblk of
// pg[k n_gate + u]: each output one thread, its terms in index order.
__global__ void __launch_bounds__(kThreads)
reduce_grads(const float* __restrict__ pbi, const float* __restrict__ pg, float* __restrict__ out,
             int G, int EE, int splits, int nblk, int n_gate) {
  const size_t j = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
  const size_t nbi = static_cast<size_t>(G) * EE;
  float acc = 0.f;
  if (j < nbi) {
    const size_t g = j / EE, u = j % EE;
    const float* p = pbi + g * splits * EE + u;
#pragma unroll 8
    for (int s = 0; s < splits; ++s) acc += p[static_cast<size_t>(s) * EE];
  } else if (j < nbi + n_gate) {
    const size_t u = j - nbi;
#pragma unroll 8
    for (int k = 0; k < nblk; ++k) acc += pg[static_cast<size_t>(k) * n_gate + u];
  } else {
    return;
  }
  out[j] = acc;
}

// ---- host-side launches ----

// V = sc W ("all": one (Q B, E) x (E, E) product; "each": Q of (B, E) x W_q).
template <typename T>
int launch_project(const T* sc, const T* wbi, float* V, int B, int F, int E, bool each,
                   cudaStream_t s) {
  const int Q = F - 1;
  const size_t be = static_cast<size_t>(B) * E, ee = static_cast<size_t>(E) * E;
  const mma::EpiPartial epi{V, E, be};
  if (each)
    return mma::launch_product<T, false, true>(sc, wbi, B, E, E, 1, E, epi, s, Q, be, ee);
  return mma::launch_product<T, false, true>(sc, wbi, Q * B, E, E, 1, E, epi, s);
}

template <typename T>
int launch_pairs(const float* g, const T* x, const float* w, const float* V, float* ds, T* dvc,
                 int B, int F, int E, bool each, cudaStream_t s) {
  const size_t threads = static_cast<size_t>(B) * (E / 4);
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  if (each) {
    CTR_WITH_FIELDS(F, pairs_bwd<T, true, NF><<<blocks, kThreads, 0, s>>>(g, x, w, V, ds, dvc, B,
                                                                         F, E);
                    return last_error())
  }
  CTR_WITH_FIELDS(F, pairs_bwd<T, false, NF><<<blocks, kThreads, 0, s>>>(g, x, w, V, ds, dvc, B,
                                                                        F, E);
                  return last_error())
}

// P = dvc W^T (Q, B, E) fp32: the projection term of each projected field.
template <typename T>
int launch_project_t(const T* dvc, const T* wbi, float* P, int B, int F, int E, bool each,
                     cudaStream_t s) {
  const int Q = F - 1;
  const size_t be = static_cast<size_t>(B) * E, ee = static_cast<size_t>(E) * E;
  const mma::EpiPartial epi{P, E, be};
  if (each)
    return mma::launch_product<T, false, false>(dvc, wbi, B, E, E, 1, E, epi, s, Q, be, ee);
  return mma::launch_product<T, false, false>(dvc, wbi, Q * B, E, E, 1, E, epi, s);
}

template <typename T>
int launch_gate_bwd(const float* ds, const float* P, const T* x, const float* z, const float* h1,
                    const float* w, const float* w1, const float* w2, T* dx, float* dh2,
                    float* dh1, float* part, int B, int F, int E, int R, int chunk, bool each,
                    cudaStream_t s) {
  const int nblk = (B + chunk - 1) / chunk;
  CTR_WITH_FIELDS(F, gate_bwd<T, NF><<<nblk, kThreads, 0, s>>>(
                         ds, P, x, z, h1, w, w1, w2, dx, dh2, dh1, part, B, F, E, R, chunk,
                         each ? 0 : 1);
                  return last_error())
}

// dW_bi partials: pbi (G splits, E, E), G = Q groups for "each" (K = B rows
// each) or 1 for "all" (K = Q B rows).
template <typename T>
int launch_weight_grad(const T* sc, const T* dvc, float* pbi, int B, int F, int E, bool each,
                       int splits, int chunk, cudaStream_t s) {
  const int Q = F - 1;
  const size_t be = static_cast<size_t>(B) * E, ee = static_cast<size_t>(E) * E;
  const mma::EpiPartial epi{pbi, E, ee};
  if (each)
    return mma::launch_product<T, true, true>(sc, dvc, E, E, B, splits, chunk, epi, s, Q, be, be);
  return mma::launch_product<T, true, true>(sc, dvc, E, E, Q * B, splits, chunk, epi, s);
}

inline int launch_reduce(const float* pbi, const float* pg, float* out, int G, int E, int splits,
                         int nblk, int n_gate, cudaStream_t s) {
  const size_t n = static_cast<size_t>(G) * E * E + n_gate;
  reduce_grads<<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      pbi, pg, out, G, E * E, splits, nblk, n_gate);
  return last_error();
}

inline bool in_envelope(int F, int E, int R) {
  return F >= 2 && E >= 8 && E % 8 == 0 && R >= 1;
}

// A K split over `rows` rows: chunk a multiple of 64, splits chunks cover it.
inline bool split_ok(int rows, int splits, int chunk) {
  return splits >= 1 && chunk >= 64 && chunk % 64 == 0 &&
         static_cast<long>(splits) * chunk >= rows &&
         static_cast<long>(splits - 1) * chunk < rows;
}

}  // namespace ibwd
}  // namespace ctr

namespace {
template <typename T>
const T* cd(const void* p) {
  return static_cast<const T*>(p);
}
template <typename T>
T* cd_mut(void* p) {
  return static_cast<T*>(p);
}
bool bad_dims(int B, int F, int E, int R) { return B < 1 || !ctr::ibwd::in_envelope(F, E, R); }
}  // namespace

// Each entry point below enqueues its launches on `stream`, requires 16-byte
// aligned pointers and F >= 2, E % 8 == 0, B >= 1, and returns a
// cudaError_t (cudaErrorInvalidValue outside the envelope). Tensors in the
// compute dtype (bf16 when is_bf16, else fp32) are void*; the rest fp32.
// Q = F - 1 projected fields; G = Q for "each", 1 for "all".

// Block 1: x (B, F, E) -> z (B, F), h1 (B, R), w (B, F), sc (Q, B, E) in cd.
extern "C" int ibwd_gate(const void* x, const float* w1, const float* b1, const float* w2,
                         const float* b2, float* z, float* h1, float* w, void* sc, int B, int F,
                         int E, int R, int is_bf16, int each, void* stream) {
  if (bad_dims(B, F, E, R)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    return ctr::launch_gate<T, false>(cd<T>(x), w1, b1, w2, b2, z, h1, w, cd_mut<T>(sc), B, F, E,
                                      R, each, s);
  }
  return ctr::launch_gate<float, false>(cd<float>(x), w1, b1, w2, b2, z, h1, w, cd_mut<float>(sc),
                                        B, F, E, R, each, s);
}

// Block 2: V (Q, B, E) fp32 = sc W ("all": W (E, E); "each": W (Q, E, E)).
extern "C" int ibwd_project(const void* sc, const void* wbi, float* V, int B, int F, int E,
                            int is_bf16, int each, void* stream) {
  if (bad_dims(B, F, E, 1)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    return ctr::ibwd::launch_project<T>(cd<T>(sc), cd<T>(wbi), V, B, F, E, each, s);
  }
  return ctr::ibwd::launch_project<float>(cd<float>(sc), cd<float>(wbi), V, B, F, E, each, s);
}

// Block 3: g (B, (F + F(F-1)/2) E), x, w (B, F), V -> ds (B, F, E) fp32 and
// dvc (Q, B, E) in cd.
extern "C" int ibwd_pairs(const float* g, const void* x, const float* w, const float* V,
                          float* ds, void* dvc, int B, int F, int E, int is_bf16, int each,
                          void* stream) {
  if (bad_dims(B, F, E, 1)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    return ctr::ibwd::launch_pairs<T>(g, cd<T>(x), w, V, ds, cd_mut<T>(dvc), B, F, E, each, s);
  }
  return ctr::ibwd::launch_pairs<float>(g, cd<float>(x), w, V, ds, cd_mut<float>(dvc), B, F, E,
                                        each, s);
}

// Block 4: P (Q, B, E) fp32 = dvc_p W_p^T, the projection term of each
// projected field p.
extern "C" int ibwd_project_t(const void* dvc, const void* wbi, float* P, int B, int F, int E,
                              int is_bf16, int each, void* stream) {
  if (bad_dims(B, F, E, 1)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    return ctr::ibwd::launch_project_t<T>(cd<T>(dvc), cd<T>(wbi), P, B, F, E, each, s);
  }
  return ctr::ibwd::launch_project_t<float>(cd<float>(dvc), cd<float>(wbi), P, B, F, E, each, s);
}

// Block 5: from ds (B, F, E) and P (Q, B, E), dx (B, F, E) in cd and the
// gate partials part (ceil(B / chunk), 2 F R + R + F) fp32, one a chunk of
// `chunk` rows; dh2 (B, F) and dh1 (B, R) fp32 are its scratch.
extern "C" int ibwd_gate_dx(const float* ds, const float* P, const void* x, const float* z,
                            const float* h1, const float* w, const float* w1, const float* w2,
                            void* dx, float* dh2, float* dh1, float* part, int B, int F, int E,
                            int R, int chunk, int is_bf16, int each, void* stream) {
  if (bad_dims(B, F, E, R) || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    return ctr::ibwd::launch_gate_bwd<T>(ds, P, cd<T>(x), z, h1, w, w1, w2, cd_mut<T>(dx), dh2,
                                         dh1, part, B, F, E, R, chunk, each, s);
  }
  return ctr::ibwd::launch_gate_bwd<float>(ds, P, cd<float>(x), z, h1, w, w1, w2,
                                           cd_mut<float>(dx), dh2, dh1, part, B, F, E, R, chunk,
                                           each, s);
}

// Block 6: pbi (G splits, E, E) fp32, split s of group g the sum of
// sc^T dvc over its chunk of the group's rows (Q B for "all", B for "each").
extern "C" int ibwd_weight_grad(const void* sc, const void* dvc, float* pbi, int B, int F, int E,
                                int splits, int chunk, int is_bf16, int each, void* stream) {
  if (bad_dims(B, F, E, 1) || !ctr::ibwd::split_ok(each ? B : (F - 1) * B, splits, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    return ctr::ibwd::launch_weight_grad<T>(cd<T>(sc), cd<T>(dvc), pbi, B, F, E, each, splits,
                                            chunk, s);
  }
  return ctr::ibwd::launch_weight_grad<float>(cd<float>(sc), cd<float>(dvc), pbi, B, F, E, each,
                                              splits, chunk, s);
}

// Block 7: out = [dW_bi (G, E, E) | the n_gate gate gradients], each the
// sum of its partials in index order.
extern "C" int ibwd_reduce(const float* pbi, const float* pg, float* out, int G, int E,
                           int splits, int nblk, int n_gate, void* stream) {
  if (G < 1 || E < 1 || splits < 1 || nblk < 1 || n_gate < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return ctr::ibwd::launch_reduce(pbi, pg, out, G, E, splits, nblk, n_gate,
                                  static_cast<cudaStream_t>(stream));
}

namespace {
// The whole call's scratch, carved from one workspace (each piece 256-byte
// aligned); with base == nullptr only its size is counted.
struct Work {
  float *z, *h1, *w, *V, *ds, *dh2, *dh1, *pbi, *pg;
  void *sc, *dvc;
  size_t bytes;
  Work(char* base, int B, int F, int E, int R, size_t esize, int G, int wsplits, int nblk) {
    size_t used = 0;
    auto take = [&](size_t n) {
      void* p = base ? base + used : nullptr;
      used += (n + 255) / 256 * 256;
      return p;
    };
    const size_t qbe = static_cast<size_t>(F - 1) * B * E;
    z = static_cast<float*>(take(sizeof(float) * B * F));
    h1 = static_cast<float*>(take(sizeof(float) * B * R));
    w = static_cast<float*>(take(sizeof(float) * B * F));
    sc = take(esize * qbe);
    V = static_cast<float*>(take(sizeof(float) * qbe));
    ds = static_cast<float*>(take(sizeof(float) * B * F * E));
    dvc = take(esize * qbe);
    dh2 = static_cast<float*>(take(sizeof(float) * B * F));
    dh1 = static_cast<float*>(take(sizeof(float) * B * R));
    pbi = static_cast<float*>(take(sizeof(float) * G * wsplits * E * E));
    pg = static_cast<float*>(take(sizeof(float) * nblk * (2 * F * R + R + F)));
    bytes = used;
  }
};
}  // namespace

// Bytes of workspace interaction_bwd needs at these sizes and splits.
extern "C" size_t interaction_bwd_workspace(int B, int F, int E, int R, int is_bf16, int each,
                                            int wsplits, int gchunk) {
  if (bad_dims(B, F, E, R) || wsplits < 1 || gchunk < 1) return 0;
  return Work(nullptr, B, F, E, R, is_bf16 ? 2 : 4, each ? F - 1 : 1, wsplits,
              (B + gchunk - 1) / gchunk)
      .bytes;
}

// The whole backward, blocks 1-7 in order on one stream (7 launches).
// g (B, (F + F(F-1)/2) E) fp32; x (B, F, E) and wbi ((E, E) or (Q, E, E))
// in cd; SENet weights fp32. Writes dx (B, F, E) in cd and out = [dW_bi |
// dW1 | db1 | dW2 | db2] fp32. workspace holds interaction_bwd_workspace
// bytes for the scratch: z, w, dh2 (B, F), h1, dh1 (B, R), V (Q, B, E; then
// P) and ds (B, F, E) fp32; sc and dvc (Q, B, E) in cd; dW_bi's partials (G wsplits, E, E)
// and the gate's (ceil(B / gchunk), 2 F R + R + F) fp32. wsplits and
// wchunk split the weight gradient's rows as ibwd_weight_grad takes them.
extern "C" int interaction_bwd(const float* g, const void* x, const float* w1, const float* b1,
                               const float* w2, const float* b2, const void* wbi, void* dx,
                               float* out, void* workspace, int B, int F, int E, int R,
                               int wsplits, int wchunk, int gchunk, int is_bf16, int each,
                               void* stream) {
  if (bad_dims(B, F, E, R) || gchunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int G = each ? F - 1 : 1;
  const int nblk = (B + gchunk - 1) / gchunk;
  const Work k(static_cast<char*>(workspace), B, F, E, R, is_bf16 ? 2 : 4, G, wsplits, nblk);
  int rc = ibwd_gate(x, w1, b1, w2, b2, k.z, k.h1, k.w, k.sc, B, F, E, R, is_bf16, each, stream);
  if (rc == 0) rc = ibwd_project(k.sc, wbi, k.V, B, F, E, is_bf16, each, stream);
  if (rc == 0) rc = ibwd_pairs(g, x, k.w, k.V, k.ds, k.dvc, B, F, E, is_bf16, each, stream);
  // V is read only by the pairs: its scratch takes the projection term P
  if (rc == 0) rc = ibwd_project_t(k.dvc, wbi, k.V, B, F, E, is_bf16, each, stream);
  if (rc == 0)
    rc = ibwd_gate_dx(k.ds, k.V, x, k.z, k.h1, k.w, w1, w2, dx, k.dh2, k.dh1, k.pg, B, F, E, R,
                      gchunk, is_bf16, each, stream);
  if (rc == 0)
    rc = ibwd_weight_grad(k.sc, k.dvc, k.pbi, B, F, E, wsplits, wchunk, is_bf16, each, stream);
  if (rc == 0) rc = ibwd_reduce(k.pbi, k.pg, out, G, E, wsplits, nblk, 2 * F * R + R + F, stream);
  return rc;
}
