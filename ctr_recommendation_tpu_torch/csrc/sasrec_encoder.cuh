// The SASRec encoder's building blocks, token-major, for Hopper (sm_90a):
// the tile product of tile_mma.cuh with the encoder's epilogues, LayerNorm
// forward and backward, attention forward and backward, column sums over
// token chunks and their fixed-order reduction. sasrec_encoder.cu enqueues
// the forward from them and sasrec_encoder_bwd.cu the backward; each also
// binds its blocks one by one for the checks on the card.
//
// Every tensor is token-major, (N, width) row-major with N = B*S tokens.
// The stream h, qkv, attention, softmax and LayerNorm are fp32; the four
// products take operands in the compute dtype T (bf16 or fp32) with fp32
// accumulation; rnd points are explicit from_f<T>() stores.
#pragma once

#include <algorithm>
#include <type_traits>
#include <vector>

#include "tile_mma.cuh"

namespace ctr {
namespace enc {

constexpr int kMaxS = 128;  // the staged attention: up to 4 keys a lane
constexpr size_t kMaxSmem = 232448;  // shared memory a block may opt into (H100)
constexpr float kEps = 1e-6f;
constexpr int kRowsPerBlock = 8;  // LayerNorm: one warp a row
constexpr int kSplitBlocks = 264;  // blocks a split sum aims at: two a streaming multiprocessor

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

  Layer(const Weights& w, int li, int E) {
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

// Dropout's parameters as a kernel receives them: the seed is read from the
// device (never from the host), and only when dropout is on. token0 is the
// global token of the batch's first row (a data-parallel rank's share starts
// at rank * rows * S); the Philox counter takes token0 + the local token,
// modulo 2^32, so a rank draws the masks of its rows of the global batch.
struct Dropout {
  const int64_t* seed;
  float rate;
  float inv_keep;  // fp32(1 / (1 - rate))
  uint32_t token0;

  // v[0..n) at columns col..col+n-1 of one group of 4 (col % 4 + n <= 4),
  // dropped in place: one Philox draw for the group. __fmul_rn: the product
  // is rounded before the residual add, never fused into it, as the plain
  // version computes it.
  template <int n>
  __device__ __forceinline__ void apply(float* v, size_t token, int col, int layer,
                                        int branch) const {
    if (rate <= 0.f) return;
    const uint4 w = dropout_words(static_cast<uint64_t>(*seed),
                                  token0 + static_cast<uint32_t>(token), col, layer, branch);
#pragma unroll
    for (int j = 0; j < n; ++j)
      v[j] = word_keeps(word_of(w, (col & 3) + j), rate) ? __fmul_rn(v[j], inv_keep) : 0.f;
  }
};

using mma::load2;
using mma::store2;

// ---- epilogues of the tile product: (row, col, split, fp32 sum) ----
// Each has a single-element form and a pair form for columns c, c + 1 (c
// even, N even), which the bf16 tile product's fragment layout hands over.

struct EpiStore {  // out = acc
  float* out;
  int ld;
  __device__ void operator()(int r, int c, int, float v) const {
    out[static_cast<size_t>(r) * ld + c] = v;
  }
  __device__ void pair(int r, int c, int, float v0, float v1) const {
    store2(out + static_cast<size_t>(r) * ld + c, v0, v1);
  }
};

struct EpiBias {  // out = acc + bias (qkv: fp32, not rounded)
  float* out;
  int ld;
  const float* bias;
  __device__ void operator()(int r, int c, int, float v) const {
    out[static_cast<size_t>(r) * ld + c] = v + bias[c];
  }
  __device__ void pair(int r, int c, int, float v0, float v1) const {
    store2(out + static_cast<size_t>(r) * ld + c, v0 + bias[c], v1 + bias[c + 1]);
  }
};

using mma::EpiRelu;  // f1 = cd(relu(acc + bias)), the FFN's hidden

// The residual add into the fp32 stream: h + drop(acc + bias), dropout site
// (layer, branch) keyed by the global token r; written back into h, or
// rounded once to T into out (the encoder's last product).
template <typename T>
struct EpiResidual {
  float* h;
  T* out;
  int ld;
  const float* bias;
  Dropout drop;
  int layer, branch;
  __device__ void operator()(int r, int c, int, float v) const {
    const size_t i = static_cast<size_t>(r) * ld + c;
    float a = v + bias[c];
    drop.apply<1>(&a, r, c, layer, branch);
    const float y = h[i] + a;
    if (out)
      out[i] = from_f<T>(y);
    else
      h[i] = y;
  }
  __device__ void pair(int r, int c, int, float v0, float v1) const {
    const size_t i = static_cast<size_t>(r) * ld + c;
    float a[2] = {v0 + bias[c], v1 + bias[c + 1]};
    drop.apply<2>(a, r, c, layer, branch);
    const float2 hv = load2(h + i);
    if (out)
      store2(out + i, hv.x + a[0], hv.y + a[1]);
    else
      store2(h + i, hv.x + a[0], hv.y + a[1]);
  }
};

// The ReLU gate of the FFN backward: dz1 = acc where f1 > 0 (f1 =
// cd(relu(z1)) is positive exactly where z1 is, but for z1 below bf16's
// least denormal), written fp32 (its bias gradient) and in cd (the operand
// of the two products that take it).
template <typename T>
struct EpiGate {
  const T* f1;
  float* out;
  T* out_c;
  int ld;
  __device__ void operator()(int r, int c, int, float v) const {
    const size_t i = static_cast<size_t>(r) * ld + c;
    const float y = to_f(f1[i]) > 0.f ? v : 0.f;
    out[i] = y;
    out_c[i] = from_f<T>(y);
  }
  __device__ void pair(int r, int c, int, float v0, float v1) const {
    const size_t i = static_cast<size_t>(r) * ld + c;
    const float2 f = load2(f1 + i);
    const float y0 = f.x > 0.f ? v0 : 0.f, y1 = f.y > 0.f ? v1 : 0.f;
    store2(out + i, y0, y1);
    store2(out_c + i, y0, y1);
  }
};

using mma::EpiPartial;  // split z's partial of a weight gradient

// ---- elementwise and per-row blocks ----

template <typename Tin, typename Tout>
__global__ void convert(const Tin* __restrict__ x, Tout* __restrict__ y, size_t n) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x)
    y[i] = from_f<Tout>(to_f(x[i]));
}

// hn = cd(xhat * scale + bias), xhat = (h - mean) * rsqrt(var + eps), fp32
// with the biased variance over the row's first E columns; one warp a row of
// ld >= E columns, any E. Columns E..ld-1 (the zero padding of a width the
// products do not take) are written 0. Also xhat and the rstd when given
// (the backward's residues).
template <typename T>
__global__ void layer_norm_fwd(const float* __restrict__ h, int N, int ld, int E,
                               const float* __restrict__ scale, const float* __restrict__ bias,
                               T* __restrict__ out, float* __restrict__ xhat,
                               float* __restrict__ rstd) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (r >= N) return;
  const float* hr = h + static_cast<size_t>(r) * ld;
  float s = 0.f;
  for (int c = lane; c < E; c += 32) s += hr[c];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float mean = s / static_cast<float>(E);
  float v = 0.f;
  for (int c = lane; c < E; c += 32) {
    const float d = hr[c] - mean;
    v += d * d;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const float rs = rsqrtf(v / static_cast<float>(E) + kEps);
  for (int c = lane; c < ld; c += 32) {
    const size_t i = static_cast<size_t>(r) * ld + c;
    const float x = c < E ? (hr[c] - mean) * rs : 0.f;
    if (xhat) xhat[i] = x;
    out[i] = from_f<T>(c < E ? __fadd_rn(__fmul_rn(x, scale[c]), bias[c]) : 0.f);
  }
  if (rstd && lane == 0) rstd[r] = rs;
}

// out = dh + rstd (d - mean(d) - xhat mean(d xhat)), d = dn * scale, the
// means over the row's first E of ld columns: the LayerNorm backward added to
// the gradient stream; one warp a row; columns E..ld-1 are written 0. out
// may be dh (in place, fp32) or the encoder's dx (T).
template <typename Tout>
__global__ void layer_norm_bwd(const float* __restrict__ dn, const float* __restrict__ xhat,
                               const float* __restrict__ rstd, const float* __restrict__ scale,
                               const float* dh, Tout* out, int N, int ld, int E) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (r >= N) return;
  const size_t base = static_cast<size_t>(r) * ld;
  float s1 = 0.f, s2 = 0.f;
  for (int c = lane; c < E; c += 32) {
    const float d = dn[base + c] * scale[c];
    s1 += d;
    s2 += d * xhat[base + c];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  const float m1 = s1 / static_cast<float>(E), m2 = s2 / static_cast<float>(E);
  const float rs = rstd[r];
  for (int c = lane; c < ld; c += 32) {
    const float d = c < E ? dn[base + c] * scale[c] : 0.f;
    out[base + c] =
        from_f<Tout>(c < E ? dh[base + c] + rs * (d - m1 - xhat[base + c] * m2) : 0.f);
  }
}

// ---- the widths the kernels run an encoder at ----

// An encoder of width E with H heads (head width D = E / H) runs on the
// kernels zero-padded where E % 32 != 0 or D % 4 != 0: each head to Dp, D
// rounded up to 32 / gcd(8, H), so that the heads fill a stream of Ep = H Dp
// columns, a multiple of 32 (the products' multiple) with 16-byte head rows
// (the attention's). The stream h, LayerNorm's output, the FFN's 4 Ep hidden
// and the residual branches keep their E real columns first; q, k, v and
// the attention's output keep head hh at columns hh Dp .. hh Dp + D - 1.
// The wrapper pads x and the weights with zeros (the padded rows and
// columns of every weight and bias are 0), so every padded column stays 0
// through the layers; LayerNorm takes its statistics over the E real
// columns; the softmax scale stays 1/sqrt(D); dropout is keyed by the
// stream's column, which is the real column. At E % 32 == 0 and D % 4 == 0
// nothing is padded (Dp = D, Ep = E).
struct Widths {
  int D, Dp, Ep;
};
__host__ __device__ inline Widths widths(int E, int H) {
  int g = 8, h = H;  // gcd(8, H)
  while (h) {
    const int t = g % h;
    g = h;
    h = t;
  }
  const int D = E / H, q = 32 / g, Dp = (D + q - 1) / q * q;
  return Widths{D, Dp, H * Dp};
}

// ---- attention, staged: one block per (history, head), S <= kMaxS ----
// Heads of width D (% 4 == 0) at columns hh D of E = H D-wide
// segments. A warp takes kQB queries (the forward, pass 1 of the backward) or kQB keys
// (pass 2) at once, so that each row it reads from shared memory serves kQB
// sums; rows are read 16 bytes a lane (lanes over keys) or 8 (lanes over a
// head's columns). Lanes over keys hold KC = ceil(S / 32) keys each (key
// j in lane j % 32, chunk j / 32; KC a template argument, 1, 2 or 4, so the
// chunks are unrolled and no register array is indexed at run time). The
// block's warps (at most 8: 256 threads) loop over the query groups (pass
// 2: the key groups). Every sum runs over its index in order. q, k, v (the
// backward also g, P and dlog) are staged whole in shared memory, which
// bounds S with D (attn_fwd_smem, attn_bwd_smem against kMaxSmem,
// attn_staged_fits); the encoder takes them where attn_staged says so, and the
// streamed kernels below everywhere else.

constexpr int kQB = 4;
constexpr int kMaxWarps = 8;

// Row stride of a staged (S, D) head: 16-byte rows with ld/4 odd, so the
// 16-byte reads of 8 lanes on 8 rows hit distinct banks.
__host__ __device__ inline int attn_ld(int D) { return ((D / 4) | 1) * 4; }
inline int attn_threads(int S) { return 32 * std::min(kMaxWarps, (S + kQB - 1) / kQB); }
inline int attn_chunks(int S) { return S <= 32 ? 1 : S <= 64 ? 2 : 4; }

// Rows t0..t0+S-1, columns c0..c0+D-1 of the row-major (N, ldg) fp32 src
// into dst (S, ld), 16 bytes a copy.
__device__ __forceinline__ void stage_heads(const float* __restrict__ src, int ldg, size_t t0,
                                            int c0, int S, int D, int ld, float* dst) {
  const int D4 = D / 4;
  for (int i = threadIdx.x; i < S * D4; i += blockDim.x) {
    const int s = i / D4, d = (i % D4) * 4;
    *reinterpret_cast<float4*>(dst + s * ld + d) =
        *reinterpret_cast<const float4*>(src + (t0 + s) * ldg + c0 + d);
  }
}

// acc[qi] += rows[i0 + qi] . row, over d in order (rows past S repeat the
// last one: computed, never stored).
__device__ __forceinline__ void dots(float acc[kQB], const float* rows, int i0, int S,
                                     const float* row, int D, int ld) {
  for (int d = 0; d < D; d += 4) {
    const float4 b = *reinterpret_cast<const float4*>(row + d);
#pragma unroll
    for (int qi = 0; qi < kQB; ++qi) {
      const float4 a = *reinterpret_cast<const float4*>(rows + min(i0 + qi, S - 1) * ld + d);
      acc[qi] = fmaf(a.x, b.x, acc[qi]);
      acc[qi] = fmaf(a.y, b.y, acc[qi]);
      acc[qi] = fmaf(a.z, b.z, acc[qi]);
      acc[qi] = fmaf(a.w, b.w, acc[qi]);
    }
  }
}

// acc[c][qi] = rows[i0 + qi] . keys[c * 32 + lane] for the lane's keys below
// S (0 elsewhere).
template <int KC>
__device__ __forceinline__ void key_dots(float (&acc)[KC][kQB], const float* rows, int i0,
                                         int S, const float* keys, int D, int ld, int lane) {
#pragma unroll
  for (int c = 0; c < KC; ++c) {
#pragma unroll
    for (int qi = 0; qi < kQB; ++qi) acc[c][qi] = 0.f;
    if (c * 32 + lane < S) dots(acc[c], rows, i0, S, keys + (c * 32 + lane) * ld, D, ld);
  }
}

// o[qi] += sum over j < S, in order, of a[j / 32][qi] (held by lane j % 32)
// times rows[j] at the lane's column pair d (0 past D).
template <int KC>
__device__ __forceinline__ void lane_weighted_rows(float (&o)[kQB][2], const float (&a)[KC][kQB],
                                                   const float* rows, int S, int d, int D,
                                                   int ld) {
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    const int n = min(32, S - c * 32);
    for (int jj = 0; jj < n; ++jj) {
      const int j = c * 32 + jj;
      const float2 r = d < D ? *reinterpret_cast<const float2*>(rows + j * ld + d) : float2{};
#pragma unroll
      for (int qi = 0; qi < kQB; ++qi) {
        const float aj = __shfl_sync(0xffffffffu, a[c][qi], jj);
        o[qi][0] = fmaf(aj, r.x, o[qi][0]);
        o[qi][1] = fmaf(aj, r.y, o[qi][1]);
      }
    }
  }
}

// One warp's query group i0..i0+kQB-1 of the attention forward: the logits
// with lanes over keys, the softmax, then ao = cd(p v) with lanes over
// column pairs (and P when given).
template <typename T, int KC>
__device__ __forceinline__ void attn_fwd_group(const float* q, const float* k, const float* v,
                                               const float* mask, T* __restrict__ ao,
                                               float* __restrict__ P, size_t prow, size_t t0,
                                               int i0, int S, int E, int D, int ld, int c0,
                                               float scale, int lane) {
  float p[KC][kQB];
  key_dots<KC>(p, q, i0, S, k, D, ld, lane);
#pragma unroll
  for (int qi = 0; qi < kQB; ++qi) {
    // keys past S: below any real logit
    float logit[KC], m = -3.0e38f;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      const int j = c * 32 + lane;
      logit[c] = j < S ? p[c][qi] * scale + mask[j] : -3.0e38f;
      m = fmaxf(m, logit[c]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      logit[c] = c * 32 + lane < S ? expf(logit[c] - m) : 0.f;
      sum += logit[c];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      const int j = c * 32 + lane;
      p[c][qi] = logit[c] / sum;
      if (P && j < S && i0 + qi < S) P[(prow + i0 + qi) * S + j] = p[c][qi];
    }
  }
  for (int d0 = 0; d0 < D; d0 += 64) {
    const int d = d0 + 2 * lane;
    float o[kQB][2] = {};
    lane_weighted_rows<KC>(o, p, v, S, d, D, ld);
#pragma unroll
    for (int qi = 0; qi < kQB; ++qi)
      if (d < D && i0 + qi < S) store2(ao + (t0 + i0 + qi) * E + c0 + d, o[qi][0], o[qi][1]);
  }
}

// ao = cd(softmax(q k^T * scale + mask) v), fp32, from qkv (N, 3E); lanes
// over keys for the logits, over column pairs for the output. P (B, H, S,
// S) keeps the softmax when given. At KC = 1 (S <= 32) each warp has one
// query group (attn_threads) and lanes one key, on a path of its own; past
// it the warps loop over the groups.
template <typename T, int KC>
__global__ void __launch_bounds__(256)
attention_fwd(const float* __restrict__ qkv, const float* __restrict__ amask, T* __restrict__ ao,
              float* __restrict__ P, int S, int E, int H, int D, float scale) {
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.x / H, hh = blockIdx.x % H, ld = attn_ld(D);
  float* q = sm;
  float* k = q + S * ld;
  float* v = k + S * ld;
  float* mask = v + S * ld;
  const size_t t0 = static_cast<size_t>(b) * S;
  stage_heads(qkv, 3 * E, t0, hh * D, S, D, ld, q);
  stage_heads(qkv, 3 * E, t0, E + hh * D, S, D, ld, k);
  stage_heads(qkv, 3 * E, t0, 2 * E + hh * D, S, D, ld, v);
  for (int s = threadIdx.x; s < S; s += blockDim.x) mask[s] = amask[t0 + s];
  __syncthreads();
  const int lane = threadIdx.x & 31, first = (threadIdx.x >> 5) * kQB;
  if constexpr (KC > 1) {
    const size_t prow = (static_cast<size_t>(b) * H + hh) * S;
    for (int i0 = first; i0 < S; i0 += (blockDim.x >> 5) * kQB)
      attn_fwd_group<T, KC>(q, k, v, mask, ao, P, prow, t0, i0, S, E, D, ld, hh * D, scale,
                            lane);
    return;
  }
  // S <= 32: one key a lane and one query group a warp, with no chunk or
  // group loop; the chunked path instantiated here takes more registers,
  // so fewer blocks an SM, and runs S = 20 slower
  const int i0 = first;
  float p[kQB] = {};
  if (lane < S) dots(p, q, i0, S, k + lane * ld, D, ld);
#pragma unroll
  for (int qi = 0; qi < kQB; ++qi) {
    // lanes past S: below any real logit
    const float logit = lane < S ? p[qi] * scale + mask[lane] : -3.0e38f;
    float m = logit;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float e = lane < S ? expf(logit - m) : 0.f;
    float sum = e;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    p[qi] = e / sum;
    if (P && lane < S && i0 + qi < S)
      P[((static_cast<size_t>(b) * H + hh) * S + i0 + qi) * S + lane] = p[qi];
  }
  for (int d0 = 0; d0 < D; d0 += 64) {
    const int d = d0 + 2 * lane;
    float o[kQB][2] = {};
    for (int j = 0; j < S; ++j) {
      const float2 vv = d < D ? *reinterpret_cast<const float2*>(v + j * ld + d) : float2{};
#pragma unroll
      for (int qi = 0; qi < kQB; ++qi) {
        const float pj = __shfl_sync(0xffffffffu, p[qi], j);
        o[qi][0] = fmaf(pj, vv.x, o[qi][0]);
        o[qi][1] = fmaf(pj, vv.y, o[qi][1]);
      }
    }
#pragma unroll
    for (int qi = 0; qi < kQB; ++qi)
      if (d < D && i0 + qi < S)
        store2(ao + (t0 + i0 + qi) * E + hh * D + d, o[qi][0], o[qi][1]);
  }
}

// The attention backward, fp32: dp = dao v^T, dlog = p (dp - sum(dp p)) scale,
// dq = dlog k, dk = dlog^T q, dv = p^T dao, into dqkv (N, 3E) fp32 and
// rounded to T (dqkv_c). Pass 1: a warp's queries, lanes over keys, then
// over column pairs; pass 2: a warp's keys, lanes over column pairs.
template <typename T, int KC>
__global__ void __launch_bounds__(256)
attention_bwd(const float* __restrict__ qkv, const float* __restrict__ P,
              const float* __restrict__ dao, float* __restrict__ dqkv, T* __restrict__ dqkv_c,
              int S, int E, int H, int D, float scale) {
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.x / H, hh = blockIdx.x % H, ld = attn_ld(D);
  const int ls = S + 1;  // row stride of p and dlog
  float* q = sm;
  float* k = q + S * ld;
  float* v = k + S * ld;
  float* g = v + S * ld;
  float* ps = g + S * ld;
  float* dl = ps + S * ls;
  const size_t t0 = static_cast<size_t>(b) * S;
  const float* pb = P + (static_cast<size_t>(b) * H + hh) * S * S;
  stage_heads(qkv, 3 * E, t0, hh * D, S, D, ld, q);
  stage_heads(qkv, 3 * E, t0, E + hh * D, S, D, ld, k);
  stage_heads(qkv, 3 * E, t0, 2 * E + hh * D, S, D, ld, v);
  stage_heads(dao, E, t0, hh * D, S, D, ld, g);
  for (int i = threadIdx.x; i < S * S; i += blockDim.x) ps[(i / S) * ls + i % S] = pb[i];
  __syncthreads();
  const int lane = threadIdx.x & 31, first = (threadIdx.x >> 5) * kQB;
  auto put = [&](size_t i, float a, float c) {
    store2(dqkv + i, a, c);
    store2(dqkv_c + i, a, c);
  };
  if constexpr (KC > 1) {
    const int step = (blockDim.x >> 5) * kQB;
    auto queries = [&](int i0) {  // pass 1: a warp's query group
      float dlog[KC][kQB];
      key_dots<KC>(dlog, g, i0, S, v, D, ld, lane);  // dp
#pragma unroll
      for (int qi = 0; qi < kQB; ++qi) {
        const int i = min(i0 + qi, S - 1);
        float p[KC], s = 0.f;
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          const int j = c * 32 + lane;
          p[c] = j < S ? ps[i * ls + j] : 0.f;
          s += dlog[c][qi] * p[c];
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          const int j = c * 32 + lane;
          dlog[c][qi] = j < S ? p[c] * (dlog[c][qi] - s) * scale : 0.f;
          if (j < S && i0 + qi < S) dl[i * ls + j] = dlog[c][qi];
        }
      }
      for (int d0 = 0; d0 < D; d0 += 64) {  // dq_i = sum_j dlog_ij k_j
        const int d = d0 + 2 * lane;
        float o[kQB][2] = {};
        lane_weighted_rows<KC>(o, dlog, k, S, d, D, ld);
#pragma unroll
        for (int qi = 0; qi < kQB; ++qi)
          if (d < D && i0 + qi < S) put((t0 + i0 + qi) * 3 * E + hh * D + d, o[qi][0], o[qi][1]);
      }
    };
    for (int i0 = first; i0 < S; i0 += step) queries(i0);
    __syncthreads();
    auto keys = [&](int j0) {  // pass 2: a warp's key group
      for (int d0 = 0; d0 < D; d0 += 64) {  // dk_j = sum_i dlog_ij q_i, dv_j = sum_i p_ij g_i
        const int d = d0 + 2 * lane;
        float dk[kQB][2] = {}, dv[kQB][2] = {};
        for (int i = 0; i < S; ++i) {
          const float2 qq = d < D ? *reinterpret_cast<const float2*>(q + i * ld + d) : float2{};
          const float2 gg = d < D ? *reinterpret_cast<const float2*>(g + i * ld + d) : float2{};
#pragma unroll
          for (int kj = 0; kj < kQB; ++kj) {
            const int j = min(j0 + kj, S - 1);
            const float a = dl[i * ls + j], pij = ps[i * ls + j];
            dk[kj][0] = fmaf(a, qq.x, dk[kj][0]);
            dk[kj][1] = fmaf(a, qq.y, dk[kj][1]);
            dv[kj][0] = fmaf(pij, gg.x, dv[kj][0]);
            dv[kj][1] = fmaf(pij, gg.y, dv[kj][1]);
          }
        }
#pragma unroll
        for (int kj = 0; kj < kQB; ++kj)
          if (d < D && j0 + kj < S) {
            const size_t o = (t0 + j0 + kj) * 3 * E + hh * D + d;
            put(o + E, dk[kj][0], dk[kj][1]);
            put(o + 2 * E, dv[kj][0], dv[kj][1]);
          }
      }
    };
    for (int j0 = first; j0 < S; j0 += step) keys(j0);
    return;
  }
  // S <= 32: one key a lane and one query (pass 2: key) group a warp, with
  // no chunk or group loop, as the forward
  const int i0 = first;
  float dlog[kQB] = {};
  if (lane < S) dots(dlog, g, i0, S, v + lane * ld, D, ld);  // dp
#pragma unroll
  for (int qi = 0; qi < kQB; ++qi) {
    const int i = min(i0 + qi, S - 1);
    const float p = lane < S ? ps[i * ls + lane] : 0.f;
    float s = dlog[qi] * p;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    dlog[qi] = lane < S ? p * (dlog[qi] - s) * scale : 0.f;
    if (lane < S && i0 + qi < S) dl[i * ls + lane] = dlog[qi];
  }
  for (int d0 = 0; d0 < D; d0 += 64) {  // dq_i = sum_j dlog_ij k_j
    const int d = d0 + 2 * lane;
    float o[kQB][2] = {};
    for (int j = 0; j < S; ++j) {
      const float2 kk = d < D ? *reinterpret_cast<const float2*>(k + j * ld + d) : float2{};
#pragma unroll
      for (int qi = 0; qi < kQB; ++qi) {
        const float dj = __shfl_sync(0xffffffffu, dlog[qi], j);
        o[qi][0] = fmaf(dj, kk.x, o[qi][0]);
        o[qi][1] = fmaf(dj, kk.y, o[qi][1]);
      }
    }
#pragma unroll
    for (int qi = 0; qi < kQB; ++qi)
      if (d < D && i0 + qi < S) put((t0 + i0 + qi) * 3 * E + hh * D + d, o[qi][0], o[qi][1]);
  }
  __syncthreads();
  const int j0 = i0;  // pass 2: this warp's keys
  for (int d0 = 0; d0 < D; d0 += 64) {  // dk_j = sum_i dlog_ij q_i, dv_j = sum_i p_ij g_i
    const int d = d0 + 2 * lane;
    float dk[kQB][2] = {}, dv[kQB][2] = {};
    for (int i = 0; i < S; ++i) {
      const float2 qq = d < D ? *reinterpret_cast<const float2*>(q + i * ld + d) : float2{};
      const float2 gg = d < D ? *reinterpret_cast<const float2*>(g + i * ld + d) : float2{};
#pragma unroll
      for (int kj = 0; kj < kQB; ++kj) {
        const int j = min(j0 + kj, S - 1);
        const float a = dl[i * ls + j], pij = ps[i * ls + j];
        dk[kj][0] = fmaf(a, qq.x, dk[kj][0]);
        dk[kj][1] = fmaf(a, qq.y, dk[kj][1]);
        dv[kj][0] = fmaf(pij, gg.x, dv[kj][0]);
        dv[kj][1] = fmaf(pij, gg.y, dv[kj][1]);
      }
    }
#pragma unroll
    for (int kj = 0; kj < kQB; ++kj)
      if (d < D && j0 + kj < S) {
        const size_t o = (t0 + j0 + kj) * 3 * E + hh * D + d;
        put(o + E, dk[kj][0], dk[kj][1]);
        put(o + 2 * E, dv[kj][0], dv[kj][1]);
      }
  }
}

inline size_t attn_fwd_smem(int S, int D) { return (3 * S * attn_ld(D) + S) * sizeof(float); }
inline size_t attn_bwd_smem(int S, int D) {
  return (4 * S * attn_ld(D) + 2 * S * (S + 1)) * sizeof(float);
}

// Whether the staged kernels take (S, D): their whole heads in shared memory
// both ways.
inline bool attn_staged_fits(int S, int D) {
  return S <= kMaxS && attn_fwd_smem(S, D) <= kMaxSmem && attn_bwd_smem(S, D) <= kMaxSmem;
}

// The encoder's route (ops/cuda/encoder_blocks.py::attention_route is the
// same rule): the staged kernels where they fit and, on an H100 at 700 W,
// ran a training step's attention (two forwards, one backward) faster than
// the streamed ones: heads deeper than 64 (D = 128: 2.20 against 3.24 ms at
// S = 32, 8.37 against 10.71 at S = 50, the forward at B = 8192 and the
// backward at 4096), and histories up to kStagedS keys (D = 64, S = 20:
// 0.75-0.79 against 0.85-0.90 ms; at S = 24 they tie, 0.90 and 0.90; at S =
// 32 the streamed ones lead, 1.06-1.08 against 1.20-1.26). The streamed
// kernels everywhere else.
constexpr int kStagedS = 20;
inline bool attn_staged(int S, int D) {
  return attn_staged_fits(S, D) && (D > 64 || S <= kStagedS);
}

// ---- attention, streamed on the tensor cores: any S, any D ----
// The counterpart of the attention inside the TPU kernels _fwd_kernel (:220)
// and _bwd_kernel (:238) of ctr_recommendation_tpu/ops/pallas/sasrec_encoder.py,
// that is _attn_fwd / _attn_bwd (:88-136): fp32 softmax(q k^T scale + mask) v
// and its backward. A block owns kBlockRows rows of one (history, head), 16 a
// warp (one m16n8k8 row tile), and walks the other side's rows in tiles of
// kTile, so that nothing of size S^2 is kept on chip or in device memory and
// no S bounds the kernels.
//
// Bound on an H100: operations. The products run on the tensor cores in
// 3xTF32 (CUTLASS's OpMultiplyAddFastF32): each fp32 operand x splits into
// hi = tf32(x) and lo = tf32(x - hi) (cvt.rna.tf32.f32's rounding), and a
// product is hi lo + lo hi + hi hi, each exact in the tensor core. That
// keeps fp32's accuracy (the dropped lo lo is below 2^-22 of the product;
// single-pass TF32 keeps 2^-11 and misses the fp32 bar by 30-60x), so the
// fp32 precision contract of the TPU kernel holds, at three TF32
// instructions a product: 4 S^2 D flops a head forward (QK^T and PV) and 10
// S^2 D backward (FlashAttention-2's five products), 3x that in TF32
// operations at 495 TFLOP/s. At B = 8192, S = 200, E = 128, H = 2 the
// forward's 167.8 GFLOP take 1.02 ms there, against 2.5 ms for the same
// work in fp32 on the CUDA cores (67 TFLOP/s). Each k-step's three
// products go into a fresh fp32 fragment that is then added to the running
// sum: the tensor core truncates its sums, and into one running
// accumulator the error grew with the depth (4-8e-7 of the output in norm
// on the card, against 1-2e-7 so). Measured on an H100 at 700 W: 7.0 ms
// forward and 14.3 ms backward (B = 4096) at that shape, 24 and 15 TFLOP/s
// of the fp32 work: the splits (a fifth of the forward), the per-step sums
// and the latency of short dependent chains at 3-4 blocks an SM bound them,
// not the tensor cores.
//
// The forward keeps each query's running max m and sum l of exp(logit - m)
// (the online softmax): at each key tile m' = max(m, the tile's logits), the
// sum and the output rescaled by exp(m - m'); at the end ao = o / l, and (m, l)
// per query is kept for the backward (stats, (B, H, S) float2) with the fp32
// output o32. Not m + log(l): beside the -1e9 pad mask the log would vanish in
// the rounding, and an all-pad history's P would not be uniform. The backward
// rebuilds P = exp(logit - m) / l a tile at a time, its logits the forward's
// bits (the same split, the same k order, the same cross-term order) and, with
// Di = sum_d g o (FlashAttention-2's rowsum(dO o O)):
//   dv_j = sum_i P_ij g_i;  ds_ij = P_ij (g_i . v_j - Di) scale;
//   dq_i = sum_j ds_ij k_j;  dk_j = sum_i ds_ij q_i.
// Its grid has two halves, one launch: blocks with blockIdx.z = 0 own query
// rows and walk the keys (dq), blocks with 1 own key rows and walk the queries
// (dk, dv): no atomics, a repeat is bit-identical.
//
// Fragments (m16n8k8, g = lane / 4, t = lane % 4): A holds rows g, g + 8 at
// columns t, t + 4; B column g at rows t, t + 4; C rows g, g + 8 at columns
// 2t, 2t + 1. A C fragment of P (or dS) becomes the A fragment of P V with its
// keys permuted (k index t -> key 2t, t + 4 -> 2t + 1), and V's rows read in
// the same order, so no shuffle re-lays it. Up to kWhole columns a head is
// staged whole in shared memory, zero-padded to 32, 64 or kWhole columns (a
// depth the kernel is compiled for, so the k loop unrolls; rows of that + 4
// floats: every fragment read hits 32 distinct banks), the other side's
// tiles double-buffered by cp.async (the masks and stats too); deeper heads
// read their fragments from device memory (L1 and L2) with the rows and
// columns past the head zero. The output columns run in chunks of 8 NT (NT
// n-tiles of accumulators a thread); where a head is wider, each chunk walks
// the tiles again and recomputes the logits. The key half computes each
// query tile's Di (four lanes a row, every load of a row issued at once)
// after the tile lands. The encoder takes these kernels everywhere but where
// the staged ones ran faster (attn_staged).

constexpr int kTile = 32;       // the other side's rows a step (keys forward)
constexpr int kWarpRows = 16;   // a warp's own rows: one m16n8k8 row tile
constexpr int kBlockRows = 64;  // a block's own rows: four warps at most
constexpr int kWhole = 128;     // heads up to this depth staged whole in shared memory
constexpr float kLog2e = 1.4426950408889634f;

// The products' depth: D rounded up to 8 (the m16n8k8 instruction's k); a
// head staged whole is padded further, to the depth its kernel is compiled
// for (32, 64 or kWhole), 0 where it is read from device memory.
__host__ __device__ inline int attn_depth(int D) { return (D + 7) / 8 * 8; }
__host__ __device__ inline int attn_staged_depth(int D) {
  const int dk = attn_depth(D);
  return dk <= 32 ? 32 : dk <= 64 ? 64 : dk <= kWhole ? kWhole : 0;
}
// A block's own rows (16 a warp) and its buffers of the other side's tiles:
// two, loading one while the other is read, where S takes more than one.
__host__ __device__ inline int attn_own_rows(int S) {
  return S >= kBlockRows ? kBlockRows : (S + kWarpRows - 1) / kWarpRows * kWarpRows;
}
__host__ __device__ inline int attn_buffers(int S) { return S > kTile ? 2 : 1; }
inline int attn_stream_threads(int S) { return 2 * attn_own_rows(S); }
// Shared memory, bytes: staged rows of DK + 4 floats (forward: the own
// queries and each buffer's keys and values; backward: two own operands and
// each buffer's two), then the masks, the stats, 1 / l and Di.
inline size_t attn_stream_fwd_smem(int S, int D) {
  const size_t R = attn_own_rows(S), NB = attn_buffers(S), DK = attn_staged_depth(D);
  const size_t rows = DK ? R + 2 * NB * kTile : 0;
  return (rows * (DK + 4) + NB * kTile) * sizeof(float);
}
inline size_t attn_stream_bwd_smem(int S, int D) {
  const size_t R = attn_own_rows(S), NB = attn_buffers(S), DK = attn_staged_depth(D);
  const size_t rows = DK ? 2 * R + 2 * NB * kTile : 0;
  return (rows * (DK + 4) + 4 * NB * kTile + R) * sizeof(float);
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest on the top 19
// bits, ties away from zero), in two integer operations: the same bits for
// every finite x; the tensor core reads the top 19.
__device__ __forceinline__ unsigned to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// The attention's one tensor-core instruction: c += a b, TF32 operands.
__device__ __forceinline__ void mma_tf32(float c[4], const unsigned a[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Tf32 {  // an fp32 value as hi + lo, both TF32
  unsigned hi, lo;
  __device__ __forceinline__ explicit Tf32(float x) {
    hi = to_tf32(x);
    lo = to_tf32(x - __uint_as_float(hi));
  }
};

struct Tf32A {  // an A fragment split
  unsigned hi[4], lo[4];
  __device__ __forceinline__ Tf32A(float a0, float a1, float a2, float a3) {
    const float a[4] = {a0, a1, a2, a3};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const Tf32 s(a[i]);
      hi[i] = s.hi;
      lo[i] = s.lo;
    }
  }
};

// acc += a b in 3xTF32: into a fresh fp32 fragment, the two cross terms (a's
// hi against b's lo first, or, SWAP, a's lo against b's hi first: so that a
// product with its operands' roles swapped sums the same terms in the same
// order), then hi hi; that k-step's sum is added to acc in fp32. (The tensor
// core sums a step's eight products and its accumulator truncated, not
// rounded: into a running accumulator the truncation would grow with the
// depth.)
template <bool SWAP>
__device__ __forceinline__ void mma3(float acc[4], const Tf32A& a, const Tf32& b0,
                                     const Tf32& b1) {
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  if (SWAP) {
    mma_tf32(c, a.lo, b0.hi, b1.hi);
    mma_tf32(c, a.hi, b0.lo, b1.lo);
  } else {
    mma_tf32(c, a.hi, b0.lo, b1.lo);
    mma_tf32(c, a.lo, b0.hi, b1.hi);
  }
  mma_tf32(c, a.hi, b0.hi, b1.hi);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += c[i];
}

__device__ __forceinline__ float exp_(float x) { return exp2f(x * kLog2e); }

struct SmemRows {  // staged rows (zero past the valid rows and columns)
  const float* p;
  int ld;
  __device__ __forceinline__ float operator()(int r, int c) const { return p[r * ld + c]; }
};
struct DeviceRows {  // rows in device memory, 0 at or past (rows, cols)
  const float* p;
  size_t ld;
  int rows, cols;
  __device__ __forceinline__ float operator()(int r, int c) const {
    return r < rows && c < cols ? __ldg(p + r * ld + c) : 0.f;
  }
};

// s[n] (16 rows x keys 8n .. 8n + 7) += a's rows 0..15 . b's rows, over
// columns 0..depth-1 in order (DK, or depth where DK is 0; a multiple of 8),
// for the nb n-tiles that hold a valid row of b.
template <bool SWAP, int DK, typename A, typename B>
__device__ __forceinline__ void tile_dots(float (&s)[4][4], const A& a, const B& b, int depth,
                                          int nb, int g, int t) {
#pragma unroll
  for (int k = 0; k < (DK ? DK : depth); k += 8) {
    const Tf32A x(a(g, k + t), a(g + 8, k + t), a(g, k + t + 4), a(g + 8, k + t + 4));
#pragma unroll
    for (int n = 0; n < 4; ++n)
      if (n < nb)
        mma3<SWAP>(s[n], x, Tf32(b(8 * n + g, k + t)), Tf32(b(8 * n + g, k + t + 4)));
  }
}

// o[n] (16 rows x columns c0 + 8n ..) += p (16 x kTile, C fragments) . r's
// rows 0..kTile-1 at those columns: p's keys permuted into the A fragment and
// r's rows read in the same order; the k-steps past nk rows and the n-tiles
// past nt skipped.
template <int NT, typename B>
__device__ __forceinline__ void tile_weighted(float (&o)[NT][4], const float (&p)[4][4],
                                              const B& r, int c0, int nk, int nt, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (8 * kk >= nk) continue;
    const Tf32A x(p[kk][0], p[kk][2], p[kk][1], p[kk][3]);
#pragma unroll
    for (int n = 0; n < NT; ++n)
      if (n < nt)
        mma3<false>(o[n], x, Tf32(r(8 * kk + 2 * t, c0 + 8 * n + g)),
                    Tf32(r(8 * kk + 2 * t + 1, c0 + 8 * n + g)));
  }
}

__device__ __forceinline__ void cp_async_small(void* smem, const void* gmem, int bytes, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? bytes : 0;  // 0: zero-filled, nothing read
  if (bytes == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

// Rows 0..rows-1 of a staged tile (stride ld): row r < n is src row r (stride
// ldg), its first D columns (D % 4 == 0); zero elsewhere up to column dk.
__device__ __forceinline__ void stage_rows(float* dst, int ld, const float* src, size_t ldg, int n,
                                           int rows, int D, int dk) {
  const int c4 = dk / 4;
  for (int i = threadIdx.x; i < rows * c4; i += blockDim.x) {
    const int r = i / c4, c = (i % c4) * 4;
    const bool ok = r < n && c < D;
    mma::cp_async16(dst + r * ld + c, ok ? src + r * ldg + c : src, ok);
  }
}
// dst[0..rows) = src[0..n) (4- or 8-byte elements), zero past n.
template <typename U>
__device__ __forceinline__ void stage_values(U* dst, const U* src, int n, int rows) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    cp_async_small(dst + r, r < n ? src + r : src, sizeof(U), r < n);
}

// di[i] = sum_d g(i, d) o(i, d) over the first D columns of rows i < n, four
// lanes a row, lane p of the four over the columns p, p + 4, ... (all of a
// row's loads issued together: DK, or D where DK is 0, deep), the four
// partial sums added in a fixed order.
template <int DK, typename A, typename B>
__device__ __forceinline__ void rows_di(const A& g, const B& o, int n, int D, float* di) {
  const int p = threadIdx.x & 3, groups = blockDim.x >> 2;
  for (int i = threadIdx.x >> 2; i < (n + groups - 1) / groups * groups; i += groups) {
    float s = 0.f;  // rows past n: g and o read as 0, nothing written
#pragma unroll
    for (int d = p; d < (DK ? DK : D); d += 4) s = fmaf(g(i, d), o(i, d), s);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (p == 0 && i < n) di[i] = s;
  }
}

// The online softmax over one key tile for the thread's rows g and g + 8 (h
// = 0, 1): s holds the tile's logits' dots and leaves with exp(logit - m'),
// 0 past nk keys; m, l (l a partial sum over the thread's columns) and o are
// rescaled.
template <int NT>
__device__ __forceinline__ void softmax_step(float (&s)[4][4], const float* mask, int nk,
                                             float scale, float (&m)[2], float (&l)[2],
                                             float (&o)[NT][4], int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -3.0e38f;  // below any real logit
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = 8 * n + 2 * t + e;
        float& v = s[n][2 * h + e];
        v = key < nk ? __fmaf_rn(v, scale, mask[key]) : -3.0e38f;
        mx = fmaxf(mx, v);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m[h], mx), alpha = exp_(m[h] - mn);
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& v = s[n][2 * h + e];
        v = 8 * n + 2 * t + e < nk ? exp_(v - mn) : 0.f;
        sum += v;
      }
    l[h] = l[h] * alpha + sum;
    m[h] = mn;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][2 * h] *= alpha;
      o[n][2 * h + 1] *= alpha;
    }
  }
}

// An output in the compute dtype, chosen at run time (one instantiation of
// each streamed kernel serves both dtypes: it builds in half the time).
struct CdOut {
  void* p;
  bool bf16;
  __device__ __forceinline__ void pair(size_t i, float a, float b) const {
    if (bf16)
      store2(static_cast<__nv_bfloat16*>(p) + i, a, b);
    else
      store2(static_cast<float*>(p) + i, a, b);
  }
};

// Commits the copies staged since the last call (the next tile's, into the
// other buffer, or none) and waits, block-wide, for the current tile's.
__device__ __forceinline__ void tile_landed() {
  mma::cp_async_commit();
  mma::cp_async_wait<1>();
  __syncthreads();
}

// ao = cd(softmax(q k^T * scale + mask) v) and, when given, o32 (the fp32
// output) and stats (m, l per query). Grid (B H, ceil(S / kBlockRows)),
// attn_stream_threads(S) threads, attn_stream_fwd_smem(S, D) bytes. DK: the
// depth the heads are staged at (attn_staged_depth), 0 where they are read
// from device memory; NT = DK / 8 output column tiles a chunk (16 at DK = 0).
template <int DK>
__global__ void __launch_bounds__(128, DK == 0 ? 1 : DK == kWhole ? 2 : 4)
attention_fwd_streamed(const float* __restrict__ qkv, const float* __restrict__ amask,
                       CdOut ao, float* __restrict__ o32, float2* __restrict__ stats,
                       int S, int E, int H, int D, float scale) {
  extern __shared__ __align__(16) float sm[];
  constexpr bool WHOLE = DK > 0;
  constexpr int NT = WHOLE ? DK / 8 : 16;
  const int dk = WHOLE ? DK : attn_depth(D), ld = dk + 4;
  const int R = attn_own_rows(S), NB = attn_buffers(S);
  const int b = blockIdx.x / H, hh = blockIdx.x % H;
  const int q0 = blockIdx.y * kBlockRows, nq = min(kBlockRows, S - q0);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int w0 = (threadIdx.x >> 5) * kWarpRows;
  const bool active = w0 < nq;  // warp-uniform
  const size_t t0 = static_cast<size_t>(b) * S, ld3 = 3 * static_cast<size_t>(E);
  const float* qg = qkv + (t0 + q0) * ld3 + hh * D;
  const float* kg = qkv + t0 * ld3 + E + hh * D;
  const float* vg = kg + E;
  float* qs = sm;  // the own queries
  float* ks = qs + (WHOLE ? R * ld : 0);  // NB buffers of kTile keys
  float* vs = ks + (WHOLE ? NB * kTile * ld : 0);
  float* ms = vs + (WHOLE ? NB * kTile * ld : 0);  // NB buffers of kTile mask values
  const int tiles = (S + kTile - 1) / kTile;
  auto stage_keys = [&](int j) {
    const int buf = j % NB, j0 = j * kTile, nk = min(kTile, S - j0);
    if (WHOLE) {
      stage_rows(ks + buf * kTile * ld, ld, kg + j0 * ld3, ld3, nk, kTile, D, dk);
      stage_rows(vs + buf * kTile * ld, ld, vg + j0 * ld3, ld3, nk, kTile, D, dk);
    }
    stage_values(ms + buf * kTile, amask + t0 + j0, nk, kTile);
  };
  for (int c0 = 0; c0 < D; c0 += 8 * NT) {
    const int nt = min(NT, (D - c0 + 7) / 8);
    float m[2] = {-3.0e38f, -3.0e38f}, l[2] = {0.f, 0.f}, o[NT][4] = {};
    if (WHOLE) stage_rows(qs, ld, qg, ld3, nq, R, D, dk);
    stage_keys(0);
    mma::cp_async_commit();
    for (int j = 0; j < tiles; ++j) {
      const int buf = j % NB, j0 = j * kTile, nk = min(kTile, S - j0);
      if (j + 1 < tiles) stage_keys(j + 1);
      tile_landed();
      if (active) {
        float s[4][4] = {};
        const int nb = (nk + 7) / 8;
        if (WHOLE)
          tile_dots<false, DK>(s, SmemRows{qs + w0 * ld, ld},
                               SmemRows{ks + buf * kTile * ld, ld}, dk, nb, g, t);
        else
          tile_dots<false, DK>(s, DeviceRows{qg + w0 * ld3, ld3, nq - w0, D},
                               DeviceRows{kg + j0 * ld3, ld3, nk, D}, dk, nb, g, t);
        softmax_step<NT>(s, ms + buf * kTile, nk, scale, m, l, o, t);
        if (WHOLE)
          tile_weighted<NT>(o, s, SmemRows{vs + buf * kTile * ld, ld}, c0, nk, nt, g, t);
        else
          tile_weighted<NT>(o, s, DeviceRows{vg + j0 * ld3, ld3, nk, D}, c0, nk, nt, g, t);
      }
      __syncthreads();  // buffer buf is consumed before tile j + 2 fills it
    }
    if (!active) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int row = w0 + g + 8 * h;
      if (row >= nq) continue;
      const size_t at = (t0 + q0 + row) * E + hh * D;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = c0 + 8 * n + 2 * t;
        if (col >= D) continue;
        const float y0 = o[n][2 * h] / l[h], y1 = o[n][2 * h + 1] / l[h];
        ao.pair(at + col, y0, y1);
        if (o32) store2(o32 + at + col, y0, y1);
      }
      if (stats && t == 0 && c0 == 0)
        stats[(static_cast<size_t>(b) * H + hh) * S + q0 + row] = make_float2(m[h], l[h]);
    }
  }
}

// The attention backward from the forward's o32 and stats, into dqkv (N, 3E)
// fp32 and rounded to T (dqkv_c). Grid (B H, ceil(S / kBlockRows), 2),
// attn_stream_threads(S) threads, attn_stream_bwd_smem(S, D) bytes; DK and
// NT as the forward's, NT the query half's chunk (the key half's holds two
// accumulators, so at most 8 n-tiles).
template <int DK>
__global__ void __launch_bounds__(128, DK == 0 ? 1 : DK == kWhole ? 1 : 3)
attention_bwd_streamed(const float* __restrict__ qkv, const float* __restrict__ amask,
                       const float* __restrict__ o32, const float2* __restrict__ stats,
                       const float* __restrict__ dao, float* __restrict__ dqkv,
                       CdOut dqkv_c, int S, int E, int H, int D, float scale) {
  extern __shared__ __align__(16) float sm[];
  constexpr bool WHOLE = DK > 0;
  constexpr int NT = WHOLE ? DK / 8 : 16;
  constexpr int NK = NT < 8 ? NT : 8;
  const int dk = WHOLE ? DK : attn_depth(D), ld = dk + 4;
  const int R = attn_own_rows(S), NB = attn_buffers(S);
  const int b = blockIdx.x / H, hh = blockIdx.x % H;
  const int r0 = blockIdx.y * kBlockRows, n = min(kBlockRows, S - r0);  // the block's own rows
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int w0 = (threadIdx.x >> 5) * kWarpRows;
  const bool active = w0 < n;  // warp-uniform
  const size_t t0 = static_cast<size_t>(b) * S, ld3 = 3 * static_cast<size_t>(E);
  const size_t srow = (static_cast<size_t>(b) * H + hh) * S;
  const float* qg = qkv + t0 * ld3 + hh * D;
  const float* kg = qg + E;
  const float* vg = kg + E;
  const float* gg = dao + t0 * E + hh * D;
  const float* og = o32 + t0 * E + hh * D;
  const size_t ldE = E;
  const int tiles = (S + kTile - 1) / kTile;
  float* own0 = sm;  // the block's own rows of two operands
  float* own1 = own0 + (WHOLE ? R * ld : 0);
  float* oth = own1 + (WHOLE ? R * ld : 0);  // NB buffers of two kTile-row operands
  float* small = oth + (WHOLE ? 2 * NB * kTile * ld : 0);
  auto oth_op = [&](int buf, int k) { return oth + (buf * 2 + k) * kTile * ld; };
  auto put = [&](size_t i, float a, float c) {
    store2(dqkv + i, a, c);
    dqkv_c.pair(i, a, c);
  };
  if (blockIdx.z == 0) {  // dq of the block's queries, the keys walked in tiles
    float* ms = small;  // NB buffers of kTile mask values
    float* di = ms + NB * kTile;  // the block's queries' Di
    auto stage_keys = [&](int j) {
      const int buf = j % NB, j0 = j * kTile, nk = min(kTile, S - j0);
      if (WHOLE) {
        stage_rows(oth_op(buf, 0), ld, kg + j0 * ld3, ld3, nk, kTile, D, dk);
        stage_rows(oth_op(buf, 1), ld, vg + j0 * ld3, ld3, nk, kTile, D, dk);
      }
      stage_values(ms + buf * kTile, amask + t0 + j0, nk, kTile);
    };
    // the own q, g and o (o in the keys' buffers, before they fill), then Di
    if (WHOLE) {
      stage_rows(own0, ld, qg + r0 * ld3, ld3, n, R, D, dk);
      stage_rows(own1, ld, gg + r0 * ldE, ldE, n, R, D, dk);
      stage_rows(oth, ld, og + r0 * ldE, ldE, n, R, D, dk);
      mma::cp_async_commit();
      mma::cp_async_wait<0>();
      __syncthreads();
      rows_di<DK>(SmemRows{own1, ld}, SmemRows{oth, ld}, n, D, di);
    } else {
      rows_di<DK>(DeviceRows{gg + r0 * ldE, ldE, n, D}, DeviceRows{og + r0 * ldE, ldE, n, D}, n,
                  D, di);
    }
    __syncthreads();  // Di is in; o's buffer is free for the keys
    float mq[2], il[2], dq_i[2];  // the thread's rows' m, 1 / l and Di
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = w0 + g + 8 * h;
      const float2 st = row < n ? stats[srow + r0 + row] : make_float2(0.f, 1.f);
      mq[h] = st.x;
      il[h] = 1.f / st.y;
      dq_i[h] = row < n ? di[row] : 0.f;
    }
    for (int c0 = 0; c0 < D; c0 += 8 * NT) {
      const int nt = min(NT, (D - c0 + 7) / 8);
      float dq[NT][4] = {};
      stage_keys(0);
      mma::cp_async_commit();
      for (int j = 0; j < tiles; ++j) {
        const int buf = j % NB, j0 = j * kTile, nk = min(kTile, S - j0);
        if (j + 1 < tiles) stage_keys(j + 1);
        tile_landed();
        if (active) {
          float s[4][4] = {}, dp[4][4] = {};
          const int nb = (nk + 7) / 8;
          if (WHOLE) {
            const SmemRows k{oth_op(buf, 0), ld}, v{oth_op(buf, 1), ld};
            tile_dots<false, DK>(s, SmemRows{own0 + w0 * ld, ld}, k, dk, nb, g, t);
            tile_dots<false, DK>(dp, SmemRows{own1 + w0 * ld, ld}, v, dk, nb, g, t);
          } else {
            const DeviceRows k{kg + j0 * ld3, ld3, nk, D}, v{vg + j0 * ld3, ld3, nk, D};
            tile_dots<false, DK>(s, DeviceRows{qg + (r0 + w0) * ld3, ld3, n - w0, D}, k, dk, nb, g,
                                 t);
            tile_dots<false, DK>(dp, DeviceRows{gg + (r0 + w0) * ldE, ldE, n - w0, D}, v, dk, nb,
                                 g, t);
          }
          const float* mk = ms + buf * kTile;
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int c = 0; c < 4; ++c)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int key = 8 * c + 2 * t + e, i = 2 * h + e;
                const float p =
                    key < nk ? exp_(__fmaf_rn(s[c][i], scale, mk[key]) - mq[h]) * il[h] : 0.f;
                s[c][i] = key < nk ? p * (dp[c][i] - dq_i[h]) * scale : 0.f;  // ds
              }
          if (WHOLE)
            tile_weighted<NT>(dq, s, SmemRows{oth_op(buf, 0), ld}, c0, nk, nt, g, t);
          else
            tile_weighted<NT>(dq, s, DeviceRows{kg + j0 * ld3, ld3, nk, D}, c0, nk, nt, g, t);
        }
        __syncthreads();  // buffer buf is consumed before tile j + 2 fills it
      }
      if (!active) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = w0 + g + 8 * h;
        if (row >= n) continue;
#pragma unroll
        for (int c = 0; c < NT; ++c) {
          const int col = c0 + 8 * c + 2 * t;
          if (col < D) put((t0 + r0 + row) * ld3 + hh * D + col, dq[c][2 * h], dq[c][2 * h + 1]);
        }
      }
    }
    return;
  }
  // dk, dv of the block's keys, the queries walked in tiles
  float2* st = reinterpret_cast<float2*>(small);  // NB buffers of a query tile's (m, l)
  float* il = small + 2 * NB * kTile;             // and of its 1 / l
  float* dis = il + NB * kTile;                   // and of its Di
  float* mk = dis + NB * kTile;                   // the block's keys' mask
  auto stage_queries = [&](int i) {
    const int buf = i % NB, i0 = i * kTile, nq = min(kTile, S - i0);
    if (WHOLE) {
      stage_rows(oth_op(buf, 0), ld, qg + i0 * ld3, ld3, nq, kTile, D, dk);
      stage_rows(oth_op(buf, 1), ld, gg + i0 * ldE, ldE, nq, kTile, D, dk);
    }
    stage_values(st + buf * kTile, stats + srow + i0, nq, kTile);
  };
  if (WHOLE) {
    stage_rows(own0, ld, kg + r0 * ld3, ld3, n, R, D, dk);
    stage_rows(own1, ld, vg + r0 * ld3, ld3, n, R, D, dk);
  }
  stage_values(mk, amask + t0 + r0, n, R);
  for (int c0 = 0; c0 < D; c0 += 8 * NK) {
    const int nt = min(NK, (D - c0 + 7) / 8);
    float dk_[NK][4] = {}, dv_[NK][4] = {};
    stage_queries(0);
    mma::cp_async_commit();
    for (int i = 0; i < tiles; ++i) {
      const int buf = i % NB, i0 = i * kTile, nq = min(kTile, S - i0);
      if (i + 1 < tiles) stage_queries(i + 1);
      tile_landed();
      // the tile's Di (o read once, from device memory) and 1 / l
      if (WHOLE)
        rows_di<DK>(SmemRows{oth_op(buf, 1), ld}, DeviceRows{og + i0 * ldE, ldE, nq, D}, nq, D,
                    dis + buf * kTile);
      else
        rows_di<DK>(DeviceRows{gg + i0 * ldE, ldE, nq, D}, DeviceRows{og + i0 * ldE, ldE, nq, D},
                    nq, D, dis + buf * kTile);
      for (int r = threadIdx.x; r < nq; r += blockDim.x)
        il[buf * kTile + r] = 1.f / st[buf * kTile + r].y;
      __syncthreads();
      if (active) {
        float s[4][4] = {}, dp[4][4] = {};
        const int nb = (nq + 7) / 8;
        // k q^T and v g^T: the query half's products with the roles swapped
        if (WHOLE) {
          const SmemRows q{oth_op(buf, 0), ld}, gq{oth_op(buf, 1), ld};
          tile_dots<true, DK>(s, SmemRows{own0 + w0 * ld, ld}, q, dk, nb, g, t);
          tile_dots<true, DK>(dp, SmemRows{own1 + w0 * ld, ld}, gq, dk, nb, g, t);
        } else {
          const DeviceRows q{qg + i0 * ld3, ld3, nq, D}, gq{gg + i0 * ldE, ldE, nq, D};
          tile_dots<true, DK>(s, DeviceRows{kg + (r0 + w0) * ld3, ld3, n - w0, D}, q, dk, nb, g,
                              t);
          tile_dots<true, DK>(dp, DeviceRows{vg + (r0 + w0) * ld3, ld3, n - w0, D}, gq, dk, nb,
                              g, t);
        }
        const float2* sb = st + buf * kTile;
        const float* ib = il + buf * kTile;
        const float* db = dis + buf * kTile;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float mkey = mk[w0 + g + 8 * h];
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int q = 8 * c + 2 * t + e, i2 = 2 * h + e;
              const float p =
                  q < nq ? exp_(__fmaf_rn(s[c][i2], scale, mkey) - sb[q].x) * ib[q] : 0.f;
              dp[c][i2] = q < nq ? p * (dp[c][i2] - db[q]) * scale : 0.f;  // ds
              s[c][i2] = p;
            }
        }
        if (WHOLE) {
          tile_weighted<NK>(dv_, s, SmemRows{oth_op(buf, 1), ld}, c0, nq, nt, g, t);
          tile_weighted<NK>(dk_, dp, SmemRows{oth_op(buf, 0), ld}, c0, nq, nt, g, t);
        } else {
          tile_weighted<NK>(dv_, s, DeviceRows{gg + i0 * ldE, ldE, nq, D}, c0, nq, nt, g, t);
          tile_weighted<NK>(dk_, dp, DeviceRows{qg + i0 * ld3, ld3, nq, D}, c0, nq, nt, g, t);
        }
      }
      __syncthreads();  // buffer buf is consumed before tile i + 2 fills it
    }
    if (!active) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = w0 + g + 8 * h;
      if (row >= n) continue;
#pragma unroll
      for (int c = 0; c < NK; ++c) {
        const int col = c0 + 8 * c + 2 * t;
        if (col >= D) continue;
        const size_t at = (t0 + r0 + row) * ld3 + hh * D + col;
        put(at + E, dk_[c][2 * h], dk_[c][2 * h + 1]);
        put(at + 2 * E, dv_[c][2 * h], dv_[c][2 * h + 1]);
      }
    }
  }
}

// ---- column sums over token chunks, and their reduction ----

enum SumMode { kSum = 0, kLnSums = 1, kGate = 2 };

// Split z's sums over the rows of its chunk [z chunk, min(N, (z + 1) chunk))
// of the (N, ncols) fp32 G (ncols % 4 == 0), four columns a lane (16-byte
// loads), 8 warps over interleaved rows combined in warp order (fixed: a
// repeat is bit-identical):
//   kSum:    part[z zs + c] = sum G
//   kLnSums: part = sum G X, part2 = sum G        (LayerNorm's dscale, dbias)
//   kGate:   v = drop(G) at site (layer, branch); gated = cd(v); part = sum v
//            (the dropout gate on dh, fused into the first read of dh; one
//            Philox draw for a lane's four columns)
template <typename T, int MODE>
__global__ void __launch_bounds__(256)
column_sums(const float* __restrict__ G, const float* __restrict__ X, T* __restrict__ gated,
            Dropout drop, int layer, int branch, int N, int ncols, int chunk,
            float* __restrict__ part, float* __restrict__ part2, size_t zstride) {
  __shared__ float red[2][8][128];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = (blockIdx.x * 32 + lane) * 4, z = blockIdx.y;
  const int r_end = min(N, (z + 1) * chunk);
  float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
  if (c < ncols) {
    for (int r = z * chunk + warp; r < r_end; r += 8) {
      const size_t i = static_cast<size_t>(r) * ncols + c;
      const float4 g4 = *reinterpret_cast<const float4*>(G + i);
      float v[4] = {g4.x, g4.y, g4.z, g4.w};
      if (MODE == kLnSums) {
        const float4 x4 = *reinterpret_cast<const float4*>(X + i);
        const float x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          s1[k] += v[k] * x[k];
          s2[k] += v[k];
        }
        continue;
      }
      if (MODE == kGate) {
        drop.apply<4>(v, r, c, layer, branch);
        store2(gated + i, v[0], v[1]);
        store2(gated + i + 2, v[2], v[3]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) s1[k] += v[k];
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    red[0][warp][lane * 4 + k] = s1[k];
    red[1][warp][lane * 4 + k] = s2[k];
  }
  __syncthreads();
  if (warp == 0 && c < ncols) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float a = 0.f, b = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        a += red[0][w][lane * 4 + k];
        b += red[1][w][lane * 4 + k];
      }
      part[z * zstride + c + k] = a;
      if (MODE == kLnSums) part2[z * zstride + c + k] = b;
    }
  }
}

// A sum over N tokens split into `count` chunks of `chunk` tokens (a
// multiple of 64, the tile product's deepest slice), each writing its own
// partial.
struct Split {
  int count, chunk;
};

// The split that gives a launch of `blocks` blocks a chunk about
// kSplitBlocks blocks in all, at most one chunk per 64 tokens.
inline Split split_for(int N, int blocks) {
  int want = (kSplitBlocks + blocks - 1) / blocks;
  want = std::max(1, std::min(want, (N + 63) / 64));
  const int chunk = ((N + want - 1) / want + 63) / 64 * 64;
  return Split{(N + chunk - 1) / chunk, chunk};
}

__host__ __device__ inline size_t grad_size(int k, int E) {
  const size_t ee = static_cast<size_t>(E) * E;
  switch (k) {
    case 0: return 3 * ee;                      // qkv_w
    case 1: return 3 * static_cast<size_t>(E);  // qkv_b
    case 2: return ee;                          // proj_w
    case 6: case 8: return 4 * ee;              // ffn1_w, ffn2_w
    case 7: return 4 * static_cast<size_t>(E);  // ffn1_b
    default: return E;                          // proj_b, ln1_s/b, ffn2_b, ln2_s/b
  }
}

// One layer's 12 weight gradients, in the stacked order: gradient k's
// partials (split[k].count of them, size[k] floats each, one after
// another) start at base[k] of the partial buffer, and its sum lands at
// dst[k] of the output. The four matrices split the token sum so that
// their products launch about kSplitBlocks blocks; the eight vectors
// (column sums, 128 columns a block) share one split.
struct GradLayout {
  size_t size[12], base[12], dst[12];
  Split split[12];
  size_t out_total, part_total;
};

inline GradLayout grad_layout(int N, int E, int L, int li) {
  auto tiles = [](int n) { return (n + mma::BM - 1) / mma::BM; };
  const int rows[12] = {E, 0, E, 0, 0, 0, E, 0, 4 * E, 0, 0, 0};  // the matrices' (M, N)
  const int cols[12] = {3 * E, 0, E, 0, 0, 0, 4 * E, 0, E, 0, 0, 0};
  const Split vec = split_for(N, (E + 127) / 128);
  GradLayout g;
  size_t o = 0, d = 0, n = 0;
  for (int k = 0; k < 12; ++k) {
    g.size[k] = grad_size(k, E);
    g.split[k] = rows[k] ? split_for(N, tiles(rows[k]) * tiles(cols[k])) : vec;
    g.base[k] = o;
    g.dst[k] = d + li * g.size[k];
    o += g.split[k].count * g.size[k];
    d += L * g.size[k];
    n += g.size[k];
  }
  g.out_total = n;
  g.part_total = o;
  return g;
}

// out[dst[k] + u] = sum over z = 0..count-1, in that order, of gradient
// k's partial z at u: one thread an output element of the layer. With
// `accumulate` that sum is added to what out holds (a later chunk of a call
// cut into chunks of rows: the chunks' sums added in chunk order).
__global__ void __launch_bounds__(256)
reduce_partials(const float* __restrict__ part, GradLayout lay, float* __restrict__ out,
                int accumulate) {
  size_t j = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
  if (j >= lay.out_total) return;
  int k = 0;
  while (j >= lay.size[k]) j -= lay.size[k++];
  const float* p = part + lay.base[k] + j;
  float acc = 0.f;
  for (int z = 0; z < lay.split[k].count; ++z) acc += p[z * lay.size[k]];
  float* o = out + lay.dst[k] + j;
  *o = accumulate ? *o + acc : acc;
}

// ---- host-side launches of the blocks ----

inline int check_launch() { return static_cast<int>(cudaGetLastError()); }

template <typename Tin, typename Tout>
int launch_convert(const Tin* x, Tout* y, size_t n, cudaStream_t s) {
  const int blocks = static_cast<int>(std::min<size_t>((n + 255) / 256, 4096));
  convert<Tin, Tout><<<blocks, 256, 0, s>>>(x, y, n);
  return check_launch();
}

template <typename T>
int launch_ln_fwd(const float* h, int N, int ld, int E, const float* scale, const float* bias,
                  T* out, float* xhat, float* rstd, cudaStream_t s) {
  layer_norm_fwd<T><<<(N + kRowsPerBlock - 1) / kRowsPerBlock, 32 * kRowsPerBlock, 0, s>>>(
      h, N, ld, E, scale, bias, out, xhat, rstd);
  return check_launch();
}

template <typename Tout>
int launch_ln_bwd(const float* dn, const float* xhat, const float* rstd, const float* scale,
                  const float* dh, Tout* out, int N, int ld, int E, cudaStream_t s) {
  layer_norm_bwd<Tout><<<(N + kRowsPerBlock - 1) / kRowsPerBlock, 32 * kRowsPerBlock, 0, s>>>(
      dn, xhat, rstd, scale, dh, out, N, ld, E);
  return check_launch();
}

// kern<<<grid, threads, smem>>> after opting into smem bytes of shared memory.
template <typename Kern, typename... Args>
int launch_smem(Kern kern, dim3 grid, int threads, size_t smem, cudaStream_t s, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, threads, smem, s>>>(args...);
  return check_launch();
}

// The staged kernels (attn_staged_fits(S, D)); heads of width D at hh D.
template <typename T>
int launch_attn_fwd(const float* qkv, const float* amask, T* ao, float* P, int B, int S, int E,
                    int H, int D, float scale, cudaStream_t s) {
  const size_t smem = attn_fwd_smem(S, D);
  const int th = attn_threads(S);
  switch (attn_chunks(S)) {
    case 1: return launch_smem(attention_fwd<T, 1>, B * H, th, smem, s, qkv, amask, ao, P, S, E,
                               H, D, scale);
    case 2: return launch_smem(attention_fwd<T, 2>, B * H, th, smem, s, qkv, amask, ao, P, S, E,
                               H, D, scale);
    default: return launch_smem(attention_fwd<T, 4>, B * H, th, smem, s, qkv, amask, ao, P, S, E,
                                H, D, scale);
  }
}

template <typename T>
int launch_attn_bwd(const float* qkv, const float* P, const float* dao, float* dqkv, T* dqkv_c,
                    int B, int S, int E, int H, int D, float scale, cudaStream_t s) {
  const size_t smem = attn_bwd_smem(S, D);
  const int th = attn_threads(S);
  switch (attn_chunks(S)) {
    case 1: return launch_smem(attention_bwd<T, 1>, B * H, th, smem, s, qkv, P, dao, dqkv,
                               dqkv_c, S, E, H, D, scale);
    case 2: return launch_smem(attention_bwd<T, 2>, B * H, th, smem, s, qkv, P, dao, dqkv,
                               dqkv_c, S, E, H, D, scale);
    default: return launch_smem(attention_bwd<T, 4>, B * H, th, smem, s, qkv, P, dao, dqkv,
                                dqkv_c, S, E, H, D, scale);
  }
}

// The streamed kernels, any S and D: heads staged whole at 32, 64 or 128
// deep (attn_staged_depth, one chunk of output columns), else read from
// device memory in chunks of 128 columns.
template <typename T>
int launch_attn_fwd_streamed(const float* qkv, const float* amask, T* ao, float* o32,
                             float2* stats, int B, int S, int E, int H, int D, float scale,
                             cudaStream_t s) {
  const dim3 grid(B * H, (S + kBlockRows - 1) / kBlockRows);
  const size_t smem = attn_stream_fwd_smem(S, D);
  const int th = attn_stream_threads(S);
  const CdOut cd{ao, std::is_same<T, __nv_bfloat16>::value};
#define CTR_FWD(DK)                                                                        \
  launch_smem(attention_fwd_streamed<DK>, grid, th, smem, s, qkv, amask, cd, o32, stats, S, \
              E, H, D, scale)
  switch (attn_staged_depth(D)) {
    case 32: return CTR_FWD(32);
    case 64: return CTR_FWD(64);
    case kWhole: return CTR_FWD(kWhole);
    default: return CTR_FWD(0);
  }
#undef CTR_FWD
}

template <typename T>
int launch_attn_bwd_streamed(const float* qkv, const float* amask, const float* o32,
                             const float2* stats, const float* dao, float* dqkv, T* dqkv_c, int B,
                             int S, int E, int H, int D, float scale, cudaStream_t s) {
  const dim3 grid(B * H, (S + kBlockRows - 1) / kBlockRows, 2);
  const size_t smem = attn_stream_bwd_smem(S, D);
  const int th = attn_stream_threads(S);
  const CdOut cd{dqkv_c, std::is_same<T, __nv_bfloat16>::value};
#define CTR_BWD(DK)                                                                     \
  launch_smem(attention_bwd_streamed<DK>, grid, th, smem, s, qkv, amask, o32, stats, dao, \
              dqkv, cd, S, E, H, D, scale)
  switch (attn_staged_depth(D)) {
    case 32: return CTR_BWD(32);
    case 64: return CTR_BWD(64);
    case kWhole: return CTR_BWD(kWhole);
    default: return CTR_BWD(0);
  }
#undef CTR_BWD
}

template <typename T, int MODE>
int launch_column_sums(const float* G, const float* X, T* gated, const Dropout& drop, int layer,
                       int branch, int N, int ncols, Split sp, float* part, float* part2,
                       size_t zstride, cudaStream_t s) {
  column_sums<T, MODE><<<dim3((ncols + 127) / 128, sp.count), 256, 0, s>>>(
      G, X, gated, drop, layer, branch, N, ncols, sp.chunk, part, part2, zstride);
  return check_launch();
}

inline int launch_reduce(const float* part, const GradLayout& lay, float* out, cudaStream_t s,
                         int accumulate = 0) {
  reduce_partials<<<static_cast<int>((lay.out_total + 255) / 256), 256, 0, s>>>(part, lay, out,
                                                                               accumulate);
  return check_launch();
}

// Attention's forward, staged or streamed by shape (attn_staged): ao, and the
// backward's residues when given (P staged; o32 and stats streamed).
template <typename T>
int launch_attention_fwd(const float* qkv, const float* amask, T* ao, float* P, float* o32,
                         float2* stats, int B, int S, int Ep, int H, int Dp, float scale,
                         cudaStream_t s) {
  if (attn_staged(S, Dp)) return launch_attn_fwd<T>(qkv, amask, ao, P, B, S, Ep, H, Dp, scale, s);
  return launch_attn_fwd_streamed<T>(qkv, amask, ao, o32, stats, B, S, Ep, H, Dp, scale, s);
}

// Whether an attention block's entry point takes heads of width D at
// columns hh D of E = H D-wide segments: 16-byte rows (D % 4 == 0), any D
// (the blocks bound one by one for the checks on the card).
inline bool attention_block_ok(int B, int S, int E, int H, int D) {
  return B >= 1 && S >= 1 && H >= 1 && D >= 4 && D % 4 == 0 && H * D == E;
}

constexpr long long kMaxTokens = 65535LL * mma::BM;  // B S: the tile product's grid rows
// S: the streamed attention's grid rows, ceil(S / kBlockRows) <= 65535
constexpr long long kMaxStreamS = 65535LL * kBlockRows;

// The shapes both entry points take, forward and backward alike, at the
// true widths (ops/cuda/sasrec_encoder.py::fits): any S and E, E % H == 0.
inline bool shapes_ok(int S, int E, int H, int L) {
  return S >= 1 && E >= 1 && H >= 1 && E % H == 0 && L >= 1;
}

// A call's envelope: the shapes, and the grids' rows: B S tokens within the
// products', S within the streamed attention's. The wrapper cuts a call of
// more tokens into chunks of rows (sasrec_encoder.py plan_chunks), each
// inside; S stays bounded (check_envelope).
inline bool in_envelope(int B, int S, int E, int H, int L) {
  return shapes_ok(S, E, H, L) && B >= 1 && static_cast<long long>(B) * S <= kMaxTokens &&
         S <= kMaxStreamS;
}

inline bool dropout_ok(const int64_t* seed, float rate) {
  return rate >= 0.f && rate < 1.f && (rate == 0.f || seed != nullptr);
}

// A bump allocator over one workspace: each piece 256-byte aligned. With
// base == nullptr it only counts, for the workspace's size.
struct Carve {
  char* base;
  size_t used = 0;
  template <typename U>
  U* take(size_t n) {
    const size_t at = used;
    used = (used + n * sizeof(U) + 255) / 256 * 256;
    return base ? reinterpret_cast<U*>(base + at) : nullptr;
  }
};

}  // namespace enc
}  // namespace ctr
