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
constexpr int kMaxD = 256;  // head width the attention kernels take
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
// Heads of width D (% 4 == 0, <= kMaxD) at columns hh D of E = H D-wide
// segments. A warp takes kQB queries (the forward, pass 1 of the backward) or kQB keys
// (pass 2) at once, so that each row it reads from shared memory serves kQB
// sums; rows are read 16 bytes a lane (lanes over keys) or 8 (lanes over a
// head's columns). Lanes over keys hold KC = ceil(S / 32) keys each (key
// j in lane j % 32, chunk j / 32; KC a template argument, 1, 2 or 4, so the
// chunks are unrolled and no register array is indexed at run time). The
// block's warps (at most 8: 256 threads) loop over the query groups (pass
// 2: the key groups). Every sum runs over its index in order. q, k, v (the
// backward also g, P and dlog) are staged whole in shared memory, which
// bounds S with D (attn_fwd_smem, attn_bwd_smem against kMaxSmem); past that
// the streamed kernels below take the history (attn_staged).

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
// both ways. The encoder takes them there and the streamed kernels past it
// (ops/cuda/encoder_blocks.py::attention_route is the same rule).
inline bool attn_staged(int S, int D) {
  return S <= kMaxS && attn_fwd_smem(S, D) <= kMaxSmem && attn_bwd_smem(S, D) <= kMaxSmem;
}

// ---- attention, streamed: any S, a block per (history, head, tile of kTile rows) ----
// Heads as for the staged kernels. Keys (the backward's dk, dv: queries) are
// walked in tiles of kTile rows through shared memory, so that nothing of
// size S^2 is kept on chip or in device memory and no S bounds the kernels.
// A warp holds kQB queries (keys) of the block's tile; within a step lanes
// run over the step's keys (queries), one a lane, for the dot products, then
// over column pairs, DC = ceil(D / 64) pairs a lane, for the weighted rows
// (DC a template argument: the accumulators stay in registers). Every sum
// runs over its index in order, and tiles in order.
//
// The forward keeps each query's running max m and sum l of exp(logit - m)
// (the online softmax): at each key tile m' = max(m, the tile's logits), the
// sum and the output rescaled by exp(m - m'); at the end ao = o / l, and
// (m, l) per query is kept for the backward (stats, (B, H, S) float2) with
// the fp32 output o32. Not m + log(l): beside the -1e9 pad mask the log
// would vanish in the rounding, and an all-pad history's P would not be
// uniform. The backward rebuilds P = exp(logit - m) / l a tile at a time (the
// logits' bits are the forward's: the same fp32 dots in the same order)
// and, with Di = sum_d g o (FlashAttention-2's rowsum(dO o O)):
//   dv_j = sum_i P_ij g_i;  ds_ij = P_ij (g_i . v_j - Di) scale;
//   dq_i = sum_j ds_ij k_j;  dk_j = sum_i ds_ij q_i.
// Its grid has two halves, one launch: blocks with blockIdx.z = 0 own a
// query tile and walk the keys (dq), blocks with 1 own a key tile and walk
// the queries (dk, dv): no atomics, a repeat is bit-identical.

constexpr int kTile = 32;  // a block's rows (8 warps x kQB) and a step's rows (a lane each)

inline int attn_stream_chunks(int D) { return (D + 63) / 64; }
inline int attn_stream_threads(int S) { return attn_threads(std::min(S, kTile)); }
inline size_t attn_stream_fwd_smem(int D) {
  return (3 * kTile * attn_ld(D) + kTile) * sizeof(float);
}
inline size_t attn_stream_bwd_smem(int D) {
  return (4 * kTile * attn_ld(D) + 4 * kTile) * sizeof(float);
}

// o[qi][c] += sum over j < n, in order, of a[qi] (held by lane j) times
// rows[j] at the lane's column pair c * 64 + 2 lane (0 past D).
template <int DC>
__device__ __forceinline__ void tile_weighted_rows(float (&o)[kQB][DC][2], const float (&a)[kQB],
                                                   const float* rows, int n, int D, int ld,
                                                   int lane) {
  for (int j = 0; j < n; ++j) {
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = c * 64 + 2 * lane;
      const float2 r = d < D ? *reinterpret_cast<const float2*>(rows + j * ld + d) : float2{};
#pragma unroll
      for (int qi = 0; qi < kQB; ++qi) {
        const float aj = __shfl_sync(0xffffffffu, a[qi], j);
        o[qi][c][0] = fmaf(aj, r.x, o[qi][c][0]);
        o[qi][c][1] = fmaf(aj, r.y, o[qi][c][1]);
      }
    }
  }
}

// ao = cd(softmax(q k^T * scale + mask) v) and, when given, o32 (the fp32
// output) and stats (m, l per query). Grid (B H, ceil(S / kTile)).
template <typename T, int DC>
__global__ void __launch_bounds__(256)
attention_fwd_streamed(const float* __restrict__ qkv, const float* __restrict__ amask,
                       T* __restrict__ ao, float* __restrict__ o32, float2* __restrict__ stats,
                       int S, int E, int H, int D, float scale) {
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.x / H, hh = blockIdx.x % H, ld = attn_ld(D);
  const int q0 = blockIdx.y * kTile, nq = min(kTile, S - q0);
  float* q = sm;
  float* k = q + kTile * ld;
  float* v = k + kTile * ld;
  float* mask = v + kTile * ld;
  const size_t t0 = static_cast<size_t>(b) * S;
  const int lane = threadIdx.x & 31, i0 = (threadIdx.x >> 5) * kQB;
  const bool active = i0 < nq;  // warp-uniform
  stage_heads(qkv, 3 * E, t0 + q0, hh * D, nq, D, ld, q);
  float m[kQB], l[kQB], o[kQB][DC][2];
#pragma unroll
  for (int qi = 0; qi < kQB; ++qi) {
    m[qi] = -3.0e38f;  // below any real logit
    l[qi] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[qi][c][0] = o[qi][c][1] = 0.f;
  }
  for (int j0 = 0; j0 < S; j0 += kTile) {
    const int nk = min(kTile, S - j0);
    __syncthreads();  // the previous step's keys are consumed
    stage_heads(qkv, 3 * E, t0 + j0, E + hh * D, nk, D, ld, k);
    stage_heads(qkv, 3 * E, t0 + j0, 2 * E + hh * D, nk, D, ld, v);
    for (int s = threadIdx.x; s < nk; s += blockDim.x) mask[s] = amask[t0 + j0 + s];
    __syncthreads();
    if (!active) continue;
    float p[kQB] = {};
    if (lane < nk) dots(p, q, i0, nq, k + lane * ld, D, ld);
#pragma unroll
    for (int qi = 0; qi < kQB; ++qi) {
      const float logit = lane < nk ? p[qi] * scale + mask[lane] : -3.0e38f;
      float mt = logit;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float mn = fmaxf(m[qi], mt);
      const float alpha = expf(m[qi] - mn);
      const float e = lane < nk ? expf(logit - mn) : 0.f;
      float sum = e;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[qi] = l[qi] * alpha + sum;
      m[qi] = mn;
      p[qi] = e;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        o[qi][c][0] *= alpha;
        o[qi][c][1] *= alpha;
      }
    }
    tile_weighted_rows<DC>(o, p, v, nk, D, ld, lane);
  }
  if (!active) return;
#pragma unroll
  for (int qi = 0; qi < kQB; ++qi) {
    if (i0 + qi >= nq) continue;
    const size_t row = t0 + q0 + i0 + qi;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = c * 64 + 2 * lane;
      if (d >= D) continue;
      const float y0 = o[qi][c][0] / l[qi], y1 = o[qi][c][1] / l[qi];
      store2(ao + row * E + hh * D + d, y0, y1);
      if (o32) store2(o32 + row * E + hh * D + d, y0, y1);
    }
    if (stats && lane == 0)
      stats[(static_cast<size_t>(b) * H + hh) * S + q0 + i0 + qi] = make_float2(m[qi], l[qi]);
  }
}

// The attention backward from the forward's o32 and stats, into dqkv (N, 3E)
// fp32 and rounded to T (dqkv_c). Grid (B H, ceil(S / kTile), 2).
template <typename T, int DC>
__global__ void __launch_bounds__(256)
attention_bwd_streamed(const float* __restrict__ qkv, const float* __restrict__ amask,
                       const float* __restrict__ o32, const float2* __restrict__ stats,
                       const float* __restrict__ dao, float* __restrict__ dqkv,
                       T* __restrict__ dqkv_c, int S, int E, int H, int D, float scale) {
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.x / H, hh = blockIdx.x % H, ld = attn_ld(D);
  const int r0 = blockIdx.y * kTile, n = min(kTile, S - r0);  // the block's own rows
  float* q = sm;
  float* g = q + kTile * ld;
  float* k = g + kTile * ld;
  float* v = k + kTile * ld;
  float* mq = v + kTile * ld;  // a staged query tile's m, l and Di
  float* lq = mq + kTile;
  float* di = lq + kTile;
  float* mask = di + kTile;  // a staged key tile's mask
  const size_t t0 = static_cast<size_t>(b) * S, srow = (static_cast<size_t>(b) * H + hh) * S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, w0 = warp * kQB;
  const int warps = blockDim.x >> 5;
  const bool active = w0 < n;  // warp-uniform
  auto stage_queries = [&](int i0, int nq) {  // q, g, m, l and Di = g . o32, a warp a row
    stage_heads(qkv, 3 * E, t0 + i0, hh * D, nq, D, ld, q);
    stage_heads(dao, E, t0 + i0, hh * D, nq, D, ld, g);
    for (int i = warp; i < nq; i += warps) {
      const size_t at = (t0 + i0 + i) * E + hh * D;
      float s = 0.f;
      for (int d = 2 * lane; d < D; d += 64) {
        const float2 gg = *reinterpret_cast<const float2*>(dao + at + d);
        const float2 oo = *reinterpret_cast<const float2*>(o32 + at + d);
        s = fmaf(gg.x, oo.x, s);
        s = fmaf(gg.y, oo.y, s);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) {
        const float2 st = stats[srow + i0 + i];
        mq[i] = st.x;
        lq[i] = st.y;
        di[i] = s;
      }
    }
  };
  auto stage_keys = [&](int j0, int nk) {
    stage_heads(qkv, 3 * E, t0 + j0, E + hh * D, nk, D, ld, k);
    stage_heads(qkv, 3 * E, t0 + j0, 2 * E + hh * D, nk, D, ld, v);
    for (int s = threadIdx.x; s < nk; s += blockDim.x) mask[s] = amask[t0 + j0 + s];
  };
  auto put = [&](size_t i, float a, float c) {
    store2(dqkv + i, a, c);
    store2(dqkv_c + i, a, c);
  };
  if (blockIdx.z == 0) {  // dq of the block's queries, the keys walked in tiles
    stage_queries(r0, n);
    float dq[kQB][DC][2] = {};
    for (int j0 = 0; j0 < S; j0 += kTile) {
      const int nk = min(kTile, S - j0);
      __syncthreads();  // the queries are staged, the previous keys consumed
      stage_keys(j0, nk);
      __syncthreads();
      if (!active) continue;
      float sc[kQB] = {}, dp[kQB] = {};
      if (lane < nk) {
        dots(sc, q, w0, n, k + lane * ld, D, ld);
        dots(dp, g, w0, n, v + lane * ld, D, ld);
      }
#pragma unroll
      for (int qi = 0; qi < kQB; ++qi) {
        const int i = min(w0 + qi, n - 1);
        const float p = lane < nk ? expf(sc[qi] * scale + mask[lane] - mq[i]) / lq[i] : 0.f;
        sc[qi] = p * (dp[qi] - di[i]) * scale;  // ds
      }
      tile_weighted_rows<DC>(dq, sc, k, nk, D, ld, lane);
    }
    if (!active) return;
#pragma unroll
    for (int qi = 0; qi < kQB; ++qi)
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = c * 64 + 2 * lane;
        if (d < D && w0 + qi < n)
          put((t0 + r0 + w0 + qi) * 3 * E + hh * D + d, dq[qi][c][0], dq[qi][c][1]);
      }
    return;
  }
  // dk, dv of the block's keys, the queries walked in tiles
  stage_keys(r0, n);
  float dk[kQB][DC][2] = {}, dv[kQB][DC][2] = {};
  for (int i0 = 0; i0 < S; i0 += kTile) {
    const int nq = min(kTile, S - i0);
    __syncthreads();  // the keys are staged, the previous queries consumed
    stage_queries(i0, nq);
    __syncthreads();
    if (!active) continue;
    float sc[kQB] = {}, dp[kQB] = {}, p[kQB];
    if (lane < nq) {
      dots(sc, k, w0, n, q + lane * ld, D, ld);
      dots(dp, v, w0, n, g + lane * ld, D, ld);
    }
#pragma unroll
    for (int kj = 0; kj < kQB; ++kj) {
      const int j = min(w0 + kj, n - 1);
      p[kj] = lane < nq ? expf(sc[kj] * scale + mask[j] - mq[lane]) / lq[lane] : 0.f;
      sc[kj] = lane < nq ? p[kj] * (dp[kj] - di[lane]) * scale : 0.f;  // ds
    }
    tile_weighted_rows<DC>(dk, sc, q, nq, D, ld, lane);
    tile_weighted_rows<DC>(dv, p, g, nq, D, ld, lane);
  }
  if (!active) return;
#pragma unroll
  for (int kj = 0; kj < kQB; ++kj)
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = c * 64 + 2 * lane;
      if (d < D && w0 + kj < n) {
        const size_t at = (t0 + r0 + w0 + kj) * 3 * E + hh * D + d;
        put(at + E, dk[kj][c][0], dk[kj][c][1]);
        put(at + 2 * E, dv[kj][c][0], dv[kj][c][1]);
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
// k's partial z at u: one thread an output element of the layer.
__global__ void __launch_bounds__(256)
reduce_partials(const float* __restrict__ part, GradLayout lay, float* __restrict__ out) {
  size_t j = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
  if (j >= lay.out_total) return;
  int k = 0;
  while (j >= lay.size[k]) j -= lay.size[k++];
  const float* p = part + lay.base[k] + j;
  float acc = 0.f;
  for (int z = 0; z < lay.split[k].count; ++z) acc += p[z * lay.size[k]];
  out[lay.dst[k] + j] = acc;
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

// The staged kernels (attn_staged(S, D)); heads of width D at hh D.
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

// The streamed kernels, any S; DC = ceil(D / 64) instantiated for D <= kMaxD.
template <typename T>
int launch_attn_fwd_streamed(const float* qkv, const float* amask, T* ao, float* o32,
                             float2* stats, int B, int S, int E, int H, int D, float scale,
                             cudaStream_t s) {
  const dim3 grid(B * H, (S + kTile - 1) / kTile);
  const size_t smem = attn_stream_fwd_smem(D);
  const int th = attn_stream_threads(S);
#define CTR_FWD(DC)                                                                          \
  launch_smem(attention_fwd_streamed<T, DC>, grid, th, smem, s, qkv, amask, ao, o32, stats, S, \
              E, H, D, scale)
  switch (attn_stream_chunks(D)) {
    case 1: return CTR_FWD(1);
    case 2: return CTR_FWD(2);
    case 3: return CTR_FWD(3);
    default: return CTR_FWD(4);
  }
#undef CTR_FWD
}

template <typename T>
int launch_attn_bwd_streamed(const float* qkv, const float* amask, const float* o32,
                             const float2* stats, const float* dao, float* dqkv, T* dqkv_c, int B,
                             int S, int E, int H, int D, float scale, cudaStream_t s) {
  const dim3 grid(B * H, (S + kTile - 1) / kTile, 2);
  const size_t smem = attn_stream_bwd_smem(D);
  const int th = attn_stream_threads(S);
#define CTR_BWD(DC)                                                                        \
  launch_smem(attention_bwd_streamed<T, DC>, grid, th, smem, s, qkv, amask, o32, stats, dao, \
              dqkv, dqkv_c, S, E, H, D, scale)
  switch (attn_stream_chunks(D)) {
    case 1: return CTR_BWD(1);
    case 2: return CTR_BWD(2);
    case 3: return CTR_BWD(3);
    default: return CTR_BWD(4);
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

inline int launch_reduce(const float* part, const GradLayout& lay, float* out, cudaStream_t s) {
  reduce_partials<<<static_cast<int>((lay.out_total + 255) / 256), 256, 0, s>>>(part, lay, out);
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
// columns hh D of E = H D-wide segments: 16-byte rows (D % 4 == 0), D up to
// kMaxD (the blocks bound one by one for the checks on the card).
inline bool attention_block_ok(int B, int S, int E, int H, int D) {
  return B >= 1 && S >= 1 && H >= 1 && D >= 4 && D % 4 == 0 && H * D == E && D <= kMaxD;
}

constexpr long long kMaxTokens = 65535LL * mma::BM;  // B S: the tile product's grid rows
constexpr long long kMaxStreamS = 65535LL * kTile;   // S: the streamed attention's grid rows

// The shapes both entry points take, forward and backward alike, at the
// true widths (ops/cuda/sasrec_encoder.py::fits): any S and E, E % H == 0,
// a head width up to kMaxD.
inline bool shapes_ok(int S, int E, int H, int L) {
  return S >= 1 && E >= 1 && H >= 1 && E % H == 0 && E / H <= kMaxD && L >= 1;
}

// A call's envelope (check_envelope): the shapes, and the grids' rows: B S
// tokens within the products', S within the streamed attention's.
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
