// SASRec transformer-encoder backward for Hopper (sm_90a).
//
// Replaces the TPU kernel ctr_recommendation_tpu/ops/pallas/sasrec_encoder.py
// ::_bwd_kernel (:238), driven there by _pallas_encode_bwd (:416). Given the
// cotangent g of the encoded history and the forward's input x, it
// recomputes the forward from the x tile (the residual dropout masks redrawn
// from the same counter-based Philox keys: seed, global token, column,
// layer, branch) and walks the layers in reverse, as the TPU kernel does:
//
//   FFN:  df2 = drop1(dh);  dW2 += cd(f1)^T cd(df2);  db2 += sum df2
//         dz1 = (cd(df2) cd(W2)^T) * [z1 > 0];  dW1 += cd(hn2)^T cd(dz1);  db1 += sum dz1
//         dh += LN2^T(cd(dz1) cd(W1)^T)                   (dln2 scale, bias summed)
//   attn: da1 = drop0(dh);  dWp += cd(ao)^T cd(da1);  dbp += sum da1
//         dao = cd(da1) cd(Wp)^T;  per head (fp32): dp = dao v^T,
//         dlog = p (dp - sum(dp p)) / sqrt(D);  dq = dlog k;  dk = dlog^T q;  dv = p^T dao
//         dWqkv += cd(hn1)^T cd(dqkv);  dbqkv += sum dqkv
//         dh += LN1^T(cd(dqkv) cd(Wqkv)^T)                (dln1 scale, bias summed)
//
// cd() is a cast to the compute dtype T; everything else is fp32, and dx is
// rounded once, to T. The 12 weight gradients are fp32.
//
// Bound on an H100: operations. At B=4096, S=20, E=128, one layer, the
// recomputed forward and the two products per weight are 99.2 GFLOP
// against ~64 MB of g, x, dx and gradients.
//
// Design. A block owns TB whole histories (1 at S=20, E=128; 2 at E=64,
// H=4): the backward needs, besides the forward's fp32 stream, the gradient
// stream dh, qkv and dqkv, the saved softmax p and dlog, the LayerNorm
// residues and the FFN's chunk buffers, 206 KB of shared memory at TB=1.
// The forward may hold 3 histories a block and the backward 1 only because
// the dropout mask is keyed by the global token, not by a tile. Each layer's
// input stream is kept in a per-block global scratch (L2-resident) so that
// the reverse walk can reload it; the FFN hidden (rows x 4E) is made E
// columns at a time, as in the forward. Transposed products (dY W^T) stage
// W by rows; A^T G sums over the tile's rows straight into the block's fp32
// partial of the weight gradients in device memory. The grid is persistent
// (at most one block per SM, each walking its tiles in a fixed order) and a
// second launch sums the partials in block order, so two launches on the
// same inputs are bit-identical and no atomics are used. At 132 blocks the
// partials are 104 MB a layer at E=128 (about 31 us of HBM each way at 3.35
// TB/s). Histories past B are zero rows with a -1e9 mask and a zero g: they
// add exactly zero. fp32 FMA on the CUDA cores: simple first.

#include "sasrec_encoder.cuh"

namespace ctr {
namespace enc {

// Elements of one layer's slice of weight gradient k (the order of the 12
// stacked operands).
__host__ __device__ inline size_t grad_size(int k, int E) {
  const size_t ee = static_cast<size_t>(E) * E;
  switch (k) {
    case 0: return 3 * ee;                  // qkv_w
    case 1: return 3 * static_cast<size_t>(E);  // qkv_b
    case 2: return ee;                      // proj_w
    case 6: case 8: return 4 * ee;          // ffn1_w, ffn2_w
    case 7: return 4 * static_cast<size_t>(E);  // ffn1_b
    default: return E;                      // proj_b, ln1_s/b, ffn2_b, ln2_s/b
  }
}

__host__ __device__ inline size_t grad_total(int E, int L) {
  size_t n = 0;
  for (int k = 0; k < 12; ++k) n += L * grad_size(k, E);
  return n;
}

// Layer li's slice of gradient k in a buffer laid out as the 12 stacked
// (L, ...) gradients one after another.
__device__ inline float* grad_ptr(float* base, int k, int li, int E, int L) {
  size_t o = 0;
  for (int j = 0; j < k; ++j) o += L * grad_size(j, E);
  return base + o + li * grad_size(k, E);
}

// Shared memory of a block of tb histories, in floats: the weight stage;
// dh, h, the product operand, ao, xhat (later dao), df and dn (np x (E+1)
// each); qkv and dqkv (np x (3E+1)); p and dlog (tb x H x S x S); the mask
// and rstd.
__host__ __device__ inline size_t bwd_smem_floats(int tb, int S, int E, int H) {
  const size_t np = pad_rows(tb * S);
  return static_cast<size_t>(E) * CB + np * (7 * (E + 1) + 2 * (3 * E + 1) + 2) +
         2 * static_cast<size_t>(tb) * H * S * S;
}

// dst[k * ldd + c] (+)= sum over rows r < n of cd(A[r, k]) cd(G[r, c]), for
// k < K and c < N (N % 4 == 0); stores on the block's first tile.
template <typename T>
__device__ void wgrad(const float* A, int lda, const float* G, int ldg, int n, int K, int N,
                      float* __restrict__ dst, int ldd, bool first) {
  const int n4 = N / 4;
  for (int t = threadIdx.x; t < K * n4; t += blockDim.x) {
    const int k = t / n4, c = (t % n4) * 4;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < n; ++r) {
      const float a = rnd<T>(A[r * lda + k]);
      const float* gr = G + r * ldg + c;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] += a * rnd<T>(gr[j]);
    }
    float* d = dst + static_cast<size_t>(k) * ldd + c;
#pragma unroll
    for (int j = 0; j < 4; ++j) d[j] = first ? acc[j] : d[j] + acc[j];
  }
}

// dst[c] (+)= sum over rows r < n of G[r, c] (times X[r, c] when X is given).
__device__ void colsum(const float* G, int ldg, const float* X, int n, int N,
                       float* __restrict__ dst, bool first) {
  for (int c = threadIdx.x; c < N; c += blockDim.x) {
    float acc = 0.f;
    for (int r = 0; r < n; ++r) acc += X ? G[r * ldg + c] * X[r * ldg + c] : G[r * ldg + c];
    dst[c] = first ? acc : dst[c] + acc;
  }
}

// dh += rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat)), dxhat = dn * scale:
// the LayerNorm backward, one warp a row.
__device__ void ln_bwd(const float* dn, const float* xh, const float* rstd, int np, int E, int ld,
                       const float* __restrict__ scale, float* dh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int r = warp; r < np; r += nwarps) {
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < E; c += 32) {
      const float d = dn[r * ld + c] * scale[c];
      s1 += d;
      s2 += d * xh[r * ld + c];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float m1 = s1 / static_cast<float>(E), m2 = s2 / static_cast<float>(E);
    for (int c = lane; c < E; c += 32) {
      const float d = dn[r * ld + c] * scale[c];
      dh[r * ld + c] = dh[r * ld + c] + rstd[r] * (d - m1 - xh[r * ld + c] * m2);
    }
  }
}

// Attention backward, pass 1: one warp per (history, head, query i), one key
// per lane: dp = dao_i . v_j, dlog = p (dp - sum_j dp p) scale (kept in DL),
// dq_i = sum_j dlog_j k_j into dqkv's q columns.
__device__ void attn_bwd_q(const float* qs, int ldq, const float* dao, int lda, const float* P,
                           float* DL, float* dqkv, int tb, int S, int E, int H, float scale) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int D = E / H;
  for (int task = warp; task < tb * H * S; task += nwarps) {
    const int i = task % S, hh = (task / S) % H, b = task / (S * H);
    const float* base = qs + static_cast<size_t>(b) * S * ldq + hh * D;
    const float* g = dao + (b * S + i) * lda + hh * D;
    const float p = lane < S ? P[static_cast<size_t>(task) * S + lane] : 0.f;
    float dp = 0.f;
    if (lane < S) {
      const float* v = base + lane * ldq + 2 * E;
      for (int d = 0; d < D; ++d) dp += g[d] * v[d];
    }
    float s = dp * p;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float dl = lane < S ? p * (dp - s) * scale : 0.f;
    if (lane < S) DL[static_cast<size_t>(task) * S + lane] = dl;
    for (int d0 = 0; d0 < D; d0 += 32) {
      const int d = d0 + lane;
      float acc = 0.f;
      for (int j = 0; j < S; ++j) {
        const float dj = __shfl_sync(0xffffffffu, dl, j);
        if (d < D) acc += dj * base[j * ldq + E + d];
      }
      if (d < D) dqkv[(b * S + i) * ldq + hh * D + d] = acc;
    }
  }
}

// Attention backward, pass 2: one warp per (history, head, key j), one
// column per lane: dk_j = sum_i dlog_ij q_i and dv_j = sum_i p_ij dao_i into
// dqkv's k and v columns.
__device__ void attn_bwd_kv(const float* qs, int ldq, const float* dao, int lda, const float* P,
                            const float* DL, float* dqkv, int tb, int S, int E, int H) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int D = E / H;
  for (int task = warp; task < tb * H * S; task += nwarps) {
    const int j = task % S, hh = (task / S) % H, b = task / (S * H);
    const size_t pbase = static_cast<size_t>(b * H + hh) * S * S;  // (b, hh, 0, 0)
    const float* q = qs + static_cast<size_t>(b) * S * ldq + hh * D;
    const float* g = dao + b * S * lda + hh * D;
    for (int d0 = 0; d0 < D; d0 += 32) {
      const int d = d0 + lane;
      if (d >= D) continue;
      float dk = 0.f, dv = 0.f;
      for (int i = 0; i < S; ++i) {
        dk += DL[pbase + i * S + j] * q[i * ldq + d];
        dv += P[pbase + i * S + j] * g[i * lda + d];
      }
      float* out = dqkv + (b * S + j) * ldq + hh * D + d;
      out[E] = dk;
      out[2 * E] = dv;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
encode_bwd_kernel(const T* __restrict__ g, const T* __restrict__ x,
                  const float* __restrict__ amask, Weights w, Dropout drop, T* __restrict__ dx,
                  float* __restrict__ part, float* __restrict__ scratch, int B, int S, int E,
                  int H, int L, int tb, float scale, int part_stride) {
  extern __shared__ __align__(16) float smem_f[];
  const int n = tb * S, np = pad_rows(n);
  const int ld1 = E + 1, ld3 = 3 * E + 1;
  const size_t b1 = static_cast<size_t>(np) * ld1, b3 = static_cast<size_t>(np) * ld3;
  float* ws = smem_f;                                  // weight stage (K x CB)
  float* DH = ws + static_cast<size_t>(E) * CB;        // gradient stream dh
  float* Hs = DH + b1;                                 // stream h; FFN: f1, then dz1
  float* As = Hs + b1;                                 // product operand: hn1, hn2
  float* AO = As + b1;                                 // cd(ao)
  float* XH = AO + b1;                                 // xhat2, dao, xhat1
  float* DF = XH + b1;                                 // df2, da1; forward: f1 chunk
  float* DN = DF + b1;                                 // dhn2, dhn1; forward: f2 sums
  float* Q = DN + b1;                                  // qkv
  float* DQ = Q + b3;                                  // dqkv
  float* P = DQ + b3;                                  // softmax (tb, H, S, S)
  float* DL = P + static_cast<size_t>(tb) * H * S * S; // dlog (tb, H, S, S)
  float* mask_s = DL + static_cast<size_t>(tb) * H * S * S;
  float* rstd = mask_s + np;

  // every buffer starts at 0: rows past n are never written and stay finite
  const size_t total = bwd_smem_floats(tb, S, E, H);
  for (size_t i = threadIdx.x; i < total; i += blockDim.x) smem_f[i] = 0.f;

  const size_t rows = static_cast<size_t>(B) * S;
  const int n_tiles = (B + tb - 1) / tb;
  const uint64_t seed = drop.read_seed();
  float* my_part = part + static_cast<size_t>(blockIdx.x) * part_stride;
  float* my_h = scratch + static_cast<size_t>(blockIdx.x) * L * np * E;
  const int E4 = 4 * E;

  // LN1, qkv, attention (p kept), h += drop0(ao Wproj + b), then LN2 into
  // As (hn2), XH (xhat2) and rstd.
  auto attention_half = [&](const Layer<T>& lw, int li, size_t g0) {
    __syncthreads();
    layer_norm<T>(Hs, As, np, E, ld1, lw.ln1_s, lw.ln1_b);
    gemm<T>(As, ld1, np, E, lw.qkv_w, 3 * E, 3 * E, ws,
            [&](int r, int c, float acc) { Q[r * ld3 + c] = acc + lw.qkv_b[c]; });
    __syncthreads();
    attention<T>(Q, ld3, AO, ld1, mask_s, tb, S, E, H, scale, P);
    gemm<T>(AO, ld1, np, E, lw.proj_w, E, E, ws, [&](int r, int c, float acc) {
      Hs[r * ld1 + c] = Hs[r * ld1 + c] + dropped(acc + lw.proj_b[c], drop.rate, drop.inv_keep,
                                                  seed, g0 + r, c, li, 0);
    });
    __syncthreads();
    layer_norm<T>(Hs, As, np, E, ld1, lw.ln2_s, lw.ln2_b, XH, rstd);
  };

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const bool first = tile == static_cast<int>(blockIdx.x);
    const size_t g0 = static_cast<size_t>(tile) * n;  // first global row (token)
    __syncthreads();  // the previous tile is done with shared memory
    for (int i = threadIdx.x; i < n * E; i += blockDim.x) {
      const int r = i / E, c = i % E;
      const bool real = g0 + r < rows;
      Hs[r * ld1 + c] = real ? to_f(x[(g0 + r) * E + c]) : 0.f;
      DH[r * ld1 + c] = real ? to_f(g[(g0 + r) * E + c]) : 0.f;
    }
    for (int r = threadIdx.x; r < n; r += blockDim.x)
      mask_s[r] = g0 + r < rows ? amask[g0 + r] : kNegInf;

    // ---- forward walk: keep each layer's input stream ----
    for (int li = 0; li < L; ++li) {
      __syncthreads();
      for (int i = threadIdx.x; i < np * E; i += blockDim.x)
        my_h[static_cast<size_t>(li) * np * E + i] = Hs[(i / E) * ld1 + i % E];
      if (li == L - 1) break;
      const Layer<T> lw(w, li, E);
      attention_half(lw, li, g0);
      for (int ch = 0; ch < 4; ++ch) {
        gemm<T>(As, ld1, np, E, lw.ffn1_w + ch * E, E4, E, ws, [&](int r, int c, float acc) {
          DF[r * ld1 + c] = rnd<T>(fmaxf(acc + lw.ffn1_b[ch * E + c], 0.f));
        });
        gemm<T>(DF, ld1, np, E, lw.ffn2_w + static_cast<size_t>(ch) * E * E, E, E, ws,
                [&](int r, int c, float acc) {
                  DN[r * ld1 + c] = ch == 0 ? acc : DN[r * ld1 + c] + acc;
                });
      }
      __syncthreads();
      for (int i = threadIdx.x; i < np * E; i += blockDim.x) {
        const int r = i / E, c = i % E;
        Hs[r * ld1 + c] = Hs[r * ld1 + c] + dropped(DN[r * ld1 + c] + lw.ffn2_b[c], drop.rate,
                                                    drop.inv_keep, seed, g0 + r, c, li, 1);
      }
    }

    // ---- reverse walk ----
    for (int li = L - 1; li >= 0; --li) {
      const Layer<T> lw(w, li, E);
      auto reload = [&]() {
        __syncthreads();
        for (int i = threadIdx.x; i < np * E; i += blockDim.x)
          Hs[(i / E) * ld1 + i % E] = my_h[static_cast<size_t>(li) * np * E + i];
      };
      if (li != L - 1) reload();
      attention_half(lw, li, g0);

      // FFN branch: f1 recomputed E columns at a time
      __syncthreads();
      for (int i = threadIdx.x; i < np * E; i += blockDim.x) {
        const int r = i / E, c = i % E;
        DF[r * ld1 + c] = dropped(DH[r * ld1 + c], drop.rate, drop.inv_keep, seed, g0 + r, c,
                                  li, 1);
      }
      for (int ch = 0; ch < 4; ++ch) {
        gemm<T>(As, ld1, np, E, lw.ffn1_w + ch * E, E4, E, ws, [&](int r, int c, float acc) {
          Hs[r * ld1 + c] = fmaxf(acc + lw.ffn1_b[ch * E + c], 0.f);
        });
        __syncthreads();
        wgrad<T>(Hs, ld1, DF, ld1, n, E, E,
                 grad_ptr(my_part, 8, li, E, L) + static_cast<size_t>(ch) * E * E, E, first);
        gemm<T, true, true>(DF, ld1, np, E, lw.ffn2_w + static_cast<size_t>(ch) * E * E, E, E,
                            ws, [&](int r, int c, float acc) {
                              Hs[r * ld1 + c] = Hs[r * ld1 + c] > 0.f ? acc : 0.f;
                            });
        __syncthreads();
        wgrad<T>(As, ld1, Hs, ld1, n, E, E, grad_ptr(my_part, 6, li, E, L) + ch * E, E4, first);
        colsum(Hs, ld1, nullptr, n, E, grad_ptr(my_part, 7, li, E, L) + ch * E, first);
        gemm<T, true, true>(Hs, ld1, np, E, lw.ffn1_w + ch * E, E4, E, ws,
                            [&](int r, int c, float acc) {
                              DN[r * ld1 + c] = ch == 0 ? acc : DN[r * ld1 + c] + acc;
                            });
      }
      __syncthreads();
      colsum(DF, ld1, nullptr, n, E, grad_ptr(my_part, 9, li, E, L), first);
      colsum(DN, ld1, XH, n, E, grad_ptr(my_part, 10, li, E, L), first);
      colsum(DN, ld1, nullptr, n, E, grad_ptr(my_part, 11, li, E, L), first);
      ln_bwd(DN, XH, rstd, np, E, ld1, lw.ln2_s, DH);

      // attention branch
      __syncthreads();
      for (int i = threadIdx.x; i < np * E; i += blockDim.x) {
        const int r = i / E, c = i % E;
        DF[r * ld1 + c] = dropped(DH[r * ld1 + c], drop.rate, drop.inv_keep, seed, g0 + r, c,
                                  li, 0);
      }
      __syncthreads();
      wgrad<T>(AO, ld1, DF, ld1, n, E, E, grad_ptr(my_part, 2, li, E, L), E, first);
      colsum(DF, ld1, nullptr, n, E, grad_ptr(my_part, 3, li, E, L), first);
      gemm<T, true, true>(DF, ld1, np, E, lw.proj_w, E, E, ws,
                          [&](int r, int c, float acc) { XH[r * ld1 + c] = acc; });
      __syncthreads();
      attn_bwd_q(Q, ld3, XH, ld1, P, DL, DQ, tb, S, E, H, scale);
      __syncthreads();
      attn_bwd_kv(Q, ld3, XH, ld1, P, DL, DQ, tb, S, E, H);
      reload();
      __syncthreads();
      layer_norm<T>(Hs, As, np, E, ld1, lw.ln1_s, lw.ln1_b, XH, rstd);
      __syncthreads();
      wgrad<T>(As, ld1, DQ, ld3, n, E, 3 * E, grad_ptr(my_part, 0, li, E, L), 3 * E, first);
      colsum(DQ, ld3, nullptr, n, 3 * E, grad_ptr(my_part, 1, li, E, L), first);
      for (int kc = 0; kc < 3; ++kc) {
        gemm<T, true, true>(DQ + kc * E, ld3, np, E, lw.qkv_w + kc * E, 3 * E, E, ws,
                            [&](int r, int c, float acc) {
                              DN[r * ld1 + c] = kc == 0 ? acc : DN[r * ld1 + c] + acc;
                            });
      }
      __syncthreads();
      colsum(DN, ld1, XH, n, E, grad_ptr(my_part, 4, li, E, L), first);
      colsum(DN, ld1, nullptr, n, E, grad_ptr(my_part, 5, li, E, L), first);
      ln_bwd(DN, XH, rstd, np, E, ld1, lw.ln1_s, DH);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n * E; i += blockDim.x) {
      const int r = i / E, c = i % E;
      if (g0 + r < rows) dx[(g0 + r) * E + c] = from_f<T>(DH[r * ld1 + c]);
    }
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

// The largest count of histories a block can hold, at most kMaxTB; 0 if
// not even one fits.
inline int bwd_tile_histories(int S, int E, int H) {
  for (int tb = kMaxTB; tb >= 1; --tb)
    if (bwd_smem_floats(tb, S, E, H) * sizeof(float) <= kMaxSmem) return tb;
  return 0;
}

template <typename T>
static int launch(const void* g, const void* x, const float* amask, const Weights& w,
                  const Dropout& drop, void* dx, float* part, float* out, float* scratch, int B,
                  int S, int E, int H, int L, float scale, int grid, int part_stride,
                  cudaStream_t stream) {
  const int tb = bwd_tile_histories(S, E, H);
  const size_t n = grad_total(E, L);
  if (tb == 0 || grid < 1 || grid > (B + tb - 1) / tb || part_stride < static_cast<long>(n) ||
      part_stride % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = bwd_smem_floats(tb, S, E, H) * sizeof(float);
  auto kern = encode_bwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), amask, w, drop, static_cast<T*>(dx),
      part, scratch, B, S, E, H, L, tb, scale, part_stride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials<<<static_cast<int>((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      part, out, grid, part_stride, static_cast<int>(n));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace enc
}  // namespace ctr

// Histories a block of the backward holds at (S, E, H); 0 outside the
// kernel's envelope.
extern "C" int sasrec_encode_bwd_tile(int S, int E, int H) {
  if (S < 1 || S > ctr::enc::kMaxS || E % 32 != 0 || E < 32 || E > 128 || H < 1 || E % H != 0)
    return 0;
  return ctr::enc::bwd_tile_histories(S, E, H);
}

// g, x and dx (B*S, E) in the compute dtype (bf16 when is_bf16, else fp32);
// amask (B, S) fp32; the 12 stacked weights as for sasrec_encode_fwd; seed,
// rate and inv_keep the forward's. Writes dx and, through `grid` per-block
// partials of part_stride floats each, out = the 12 fp32 weight gradients
// (L, ...) one after another in the weights' order. scratch holds grid * L *
// pad_rows(tb * S) * E floats (tb = sasrec_encode_bwd_tile). Two launches
// (the kernel, then the reduction). Requires the forward's envelope and
// 16-byte aligned pointers. Returns a cudaError_t.
extern "C" int sasrec_encode_bwd(const void* g, const void* x, const float* amask,
                                 const void* qkv_w, const float* qkv_b, const void* proj_w,
                                 const float* proj_b, const float* ln1_s, const float* ln1_b,
                                 const void* ffn1_w, const float* ffn1_b, const void* ffn2_w,
                                 const float* ffn2_b, const float* ln2_s, const float* ln2_b,
                                 const int64_t* seed, void* dx, float* part, float* out,
                                 float* scratch, int B, int S, int E, int H, int L, float scale,
                                 float rate, float inv_keep, int is_bf16, int grid,
                                 int part_stride, void* stream) {
  if (sasrec_encode_bwd_tile(S, E, H) == 0 || L < 1 || B < 1 || !(rate >= 0.f && rate < 1.f) ||
      (rate > 0.f && seed == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const ctr::enc::Weights w{qkv_w, qkv_b, proj_w, proj_b, ln1_s, ln1_b,
                            ffn1_w, ffn1_b, ffn2_w, ffn2_b, ln2_s, ln2_b};
  const ctr::enc::Dropout drop{seed, rate, inv_keep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return ctr::enc::launch<__nv_bfloat16>(g, x, amask, w, drop, dx, part, out, scratch, B, S, E,
                                           H, L, scale, grid, part_stride, s);
  return ctr::enc::launch<float>(g, x, amask, w, drop, dx, part, out, scratch, B, S, E, H, L,
                                 scale, grid, part_stride, s);
}
