// Device pieces shared by the SASRec encoder's forward (sasrec_encoder.cu)
// and backward (sasrec_encoder_bwd.cu) kernels: the weights of one layer,
// the products with a weight staged from L2, LayerNorm, attention and the
// residual dropout. Both kernels keep the TPU kernel's rounding points (see
// sasrec_encoder.cu); every value here is fp32 unless rnd<T>() rounds it to
// the compute dtype T.
#pragma once

#include "common.cuh"

namespace ctr {
namespace enc {

constexpr int CB = 128;          // weight columns staged per step
constexpr int RT = 4, CT = 8;    // a thread's output tile in the products
constexpr int kMaxS = 32;        // attention keeps one key per lane
constexpr int kMaxTB = 16;
constexpr float kNegInf = -1e9f;
constexpr float kEps = 1e-6f;

struct Weights {  // the 12 stacked (L, ...) operands
  const void* qkv_w;
  const float* qkv_b;
  const void* proj_w;
  const float* proj_b;
  const float* ln1_s;
  const float* ln1_b;
  const void* ffn1_w;
  const float* ffn1_b;
  const void* ffn2_w;
  const float* ffn2_b;
  const float* ln2_s;
  const float* ln2_b;
};

template <typename T>
struct Layer {  // layer li's slice of the stacked operands
  const T* qkv_w;
  const float* qkv_b;
  const T* proj_w;
  const float* proj_b;
  const float* ln1_s;
  const float* ln1_b;
  const T* ffn1_w;
  const float* ffn1_b;
  const T* ffn2_w;
  const float* ffn2_b;
  const float* ln2_s;
  const float* ln2_b;

  __device__ Layer(const Weights& w, int li, int E) {
    const size_t ee = static_cast<size_t>(E) * E;
    qkv_w = static_cast<const T*>(w.qkv_w) + li * 3 * ee;
    qkv_b = w.qkv_b + li * 3 * E;
    proj_w = static_cast<const T*>(w.proj_w) + li * ee;
    proj_b = w.proj_b + li * E;
    ln1_s = w.ln1_s + li * E;
    ln1_b = w.ln1_b + li * E;
    ffn1_w = static_cast<const T*>(w.ffn1_w) + li * 4 * ee;
    ffn1_b = w.ffn1_b + li * 4 * E;
    ffn2_w = static_cast<const T*>(w.ffn2_w) + li * 4 * ee;
    ffn2_b = w.ffn2_b + li * E;
    ln2_s = w.ln2_s + li * E;
    ln2_b = w.ln2_b + li * E;
  }
};

__host__ __device__ inline int pad_rows(int n) { return (n + RT - 1) / RT * RT; }

// C (np x ncols) = A (np x K, shared, row stride lda) times a weight in T,
// one staged column block (K x CB floats in ws) at a time; epi(r, c, acc)
// receives each fp32 sum. W (K x ncols, row stride ldw) when !TRANS; when
// TRANS the product is A W^T with W (ncols x K, row stride ldw), staged by
// rows (K % 8 == 0). ROUND_A rounds A's elements to T as they are read (an
// fp32 buffer that is a product's cd operand). Starts with a barrier (A
// complete, the stage free); the caller puts one after it before reading
// what epi wrote.
template <typename T, bool TRANS = false, bool ROUND_A = false, typename Epi>
__device__ __forceinline__ void gemm(const float* A, int lda, int np, int K, const T* W,
                                     int ldw, int ncols, float* ws, Epi epi) {
  for (int c0 = 0; c0 < ncols; c0 += CB) {
    const int cb = min(CB, ncols - c0);
    __syncthreads();
    if (TRANS) {
      for (int i = threadIdx.x; i < (K / 8) * cb; i += blockDim.x) {
        const int c = i % cb, k = (i / cb) * 8;
        alignas(16) float v[8];
        load8(v, W + static_cast<size_t>(c0 + c) * ldw + k);
#pragma unroll
        for (int j = 0; j < 8; ++j) ws[(k + j) * cb + c] = v[j];
      }
    } else {
      const int per_row = cb / 8;
      for (int i = threadIdx.x; i < K * per_row; i += blockDim.x) {
        const int k = i / per_row, j = (i % per_row) * 8;
        load8(ws + k * cb + j, W + static_cast<size_t>(k) * ldw + c0 + j);
      }
    }
    __syncthreads();
    const int ncg = cb / CT;
    const int ntiles = (np / RT) * ncg;
    for (int t = threadIdx.x; t < ntiles; t += blockDim.x) {
      // columns 4g..4g+3 and cb/2+4g..cb/2+4g+3: a warp's float4 reads of
      // a stage row are contiguous
      const int r0 = (t / ncg) * RT, cl = (t % ncg) * 4, half = cb / 2;
      float acc[RT][CT];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) acc[i][j] = 0.f;
      const float* a0 = A + r0 * lda;
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        float a[RT];
#pragma unroll
        for (int i = 0; i < RT; ++i) a[i] = ROUND_A ? rnd<T>(a0[i * lda + k]) : a0[i * lda + k];
        const float4 w0 = *reinterpret_cast<const float4*>(ws + k * cb + cl);
        const float4 w1 = *reinterpret_cast<const float4*>(ws + k * cb + half + cl);
        const float w[CT] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < CT; ++j) acc[i][j] += a[i] * w[j];
      }
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) epi(r0 + i, c0 + cl + (j < 4 ? j : half + j - 4), acc[i][j]);
    }
  }
}

// out = cd(xhat * scale + bias), xhat = (h - mean) * rsqrt(var + eps), fp32,
// one warp a row; also xhat and rsqrt(var + eps) when xh / rstd are given.
template <typename T>
__device__ void layer_norm(const float* hs, float* out, int np, int E, int ld,
                           const float* __restrict__ scale, const float* __restrict__ bias,
                           float* xh = nullptr, float* rstd = nullptr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int r = warp; r < np; r += nwarps) {
    const float* h = hs + r * ld;
    float s = 0.f;
    for (int c = lane; c < E; c += 32) s += h[c];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mean = s / static_cast<float>(E);
    float v = 0.f;
    for (int c = lane; c < E; c += 32) {
      const float d = h[c] - mean;
      v += d * d;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    const float rs = rsqrtf(v / static_cast<float>(E) + kEps);
    for (int c = lane; c < E; c += 32) {
      const float x = (h[c] - mean) * rs;
      if (xh) xh[r * ld + c] = x;
      out[r * ld + c] = rnd<T>(x * scale[c] + bias[c]);
    }
    if (rstd && lane == 0) rstd[r] = rs;
  }
}

// ao = cd(softmax(q k^T * scale + mask) v) per history and head, fp32; one
// warp per (history, head, query), one key per lane. When P is given, the
// softmax row is kept there, (tb, H, S, S).
template <typename T>
__device__ void attention(const float* qs, int ldq, float* ao, int lda, const float* mask_s,
                          int tb, int S, int E, int H, float scale, float* P = nullptr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int D = E / H;
  for (int task = warp; task < tb * H * S; task += nwarps) {
    const int i = task % S, hh = (task / S) % H, b = task / (S * H);
    const float* base = qs + static_cast<size_t>(b) * S * ldq + hh * D;
    const float* q = base + i * ldq;
    float logit = -3.0e38f;  // lanes past S: below any real logit
    if (lane < S) {
      const float* k = base + lane * ldq + E;
      float acc = 0.f;
      for (int d = 0; d < D; ++d) acc += q[d] * k[d];
      logit = acc * scale + mask_s[b * S + lane];
    }
    float m = logit;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float e = lane < S ? expf(logit - m) : 0.f;
    float sum = e;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float p = e / sum;
    if (P && lane < S) P[static_cast<size_t>(task) * S + lane] = p;
    const float* v = base + 2 * E;
    for (int d0 = 0; d0 < D; d0 += 32) {
      const int d = d0 + lane;
      float o = 0.f;
      for (int j = 0; j < S; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        if (d < D) o += pj * v[j * ldq + d];
      }
      if (d < D) ao[(b * S + i) * lda + hh * D + d] = rnd<T>(o);
    }
  }
}

// v with the residual dropout of site (layer, branch) at (token, col): kept
// values times inv_keep = fp32(1 / (1 - rate)), dropped ones 0; v itself at
// rate 0.
__device__ __forceinline__ float dropped(float v, float rate, float inv_keep, uint64_t seed,
                                         size_t token, int col, int layer, int branch) {
  if (rate <= 0.f) return v;
  // __fmul_rn: the product is rounded before the residual add, never fused
  // into it, as the plain version computes it
  return dropout_keep(seed, static_cast<uint32_t>(token), col, layer, branch, rate)
             ? __fmul_rn(v, inv_keep)
             : 0.f;
}

// Dropout's parameters as a kernel receives them: the seed is read from the
// device (never from the host), and only when dropout is on.
struct Dropout {
  const int64_t* seed;
  float rate;
  float inv_keep;

  __device__ uint64_t read_seed() const {
    return rate > 0.f ? static_cast<uint64_t>(*seed) : 0ull;
  }
};

}  // namespace enc
}  // namespace ctr
