// SASRec transformer-encoder forward for Hopper (sm_90a).
//
// Replaces the TPU kernel ctr_recommendation_tpu/ops/pallas/sasrec_encoder.py
// ::_fwd_kernel (:220). For each history of S steps (pos-embedded, pad rows
// zeroed by the wrapper) it runs L pre-LayerNorm blocks:
//
//   hn1 = cd(LN1(h));  qkv = hn1 Wqkv + bqkv                 (fp32, not rounded)
//   per head: p = softmax(q k^T / sqrt(D) + mask);  ao = cd(p v)
//   h  += ao Wproj + bproj
//   hn2 = cd(LN2(h));  f1 = cd(relu(hn2 W1 + b1));  h += f1 W2 + b2
//
// The stream h is fp32 for all L layers (x upcast once, the output rounded
// once to x's dtype); LayerNorm (biased variance, eps 1e-6), the attention
// products and the softmax are fp32; the four weight products take operands
// rounded to the compute dtype cd and accumulate in fp32; biases are fp32.
// The mask is additive (-1e9 at pad keys, never -inf), so a history that is
// all pad gives a uniform softmax. Pad rows are not re-zeroed between layers:
// masked keys keep them out of every real row, and the wrapper zeroes them
// on output.
//
// Bound on an H100: operations. At B=8192, S=20, E=128, one layer, the
// forward is 66.1 GFLOP (201,728 MACs a token) against ~85 MB moved. The TPU
// kernel keeps a tile's activations and all of a layer's weights (384 KB in
// bf16) in 16 MB of VMEM; a Hopper block has 227 KB of shared memory. So a
// block owns TB whole histories (attention needs every step of one), keeps
// their fp32 stream, the current matmul operand and the fp32 qkv in shared
// memory for all L layers, and stages the weights from L2 one column block
// (K x 128) at a time; the FFN hidden (rows x 4E) never lives whole: it is
// made E columns at a time and consumed at once into an fp32 f2 buffer. The
// products are fp32 FMA on the CUDA cores, each thread owning a 4 x 8 output
// tile; tensor cores (mma.sync / wgmma) are later work.
//
// TB is the largest count of histories whose buffers fit (3 at S=20,
// E=128); the buffers' row strides are odd so that the column reads of the
// products and of attention hit distinct banks. Histories past B are zero
// rows with a -1e9 mask and are never stored.

#include "common.cuh"

namespace ctr {
namespace enc {

constexpr int CB = 128;          // weight columns staged per step
constexpr int RT = 4, CT = 8;    // a thread's output tile in the products
constexpr int kMaxS = 32;        // attention keeps one key per lane
constexpr int kMaxTB = 16;
constexpr float kNegInf = -1e9f;
constexpr float kEps = 1e-6f;

struct Weights {  // one layer's slice of the 12 stacked (L, ...) operands
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

__host__ __device__ inline int pad_rows(int n) { return (n + RT - 1) / RT * RT; }

// Shared memory of a block of tb histories, in floats: the weight stage,
// then h, the product operand and qkv (which the FFN reuses), then the mask.
__host__ __device__ inline size_t smem_floats(int tb, int S, int E) {
  const size_t np = pad_rows(tb * S);
  return static_cast<size_t>(E) * CB + np * (2 * (E + 1) + 3 * E + 1) + pad_rows(tb * S);
}

// C (np x ncols) = A (np x K, shared, row stride lda) times W (K x ncols,
// global in T, row stride ldw), one staged column block at a time; epi(r, c,
// acc) receives each fp32 sum. Starts with a barrier (A complete, the stage
// free); the caller puts one after it before reading what epi wrote.
template <typename T, typename Epi>
__device__ __forceinline__ void gemm(const float* A, int lda, int np, int K, const T* W,
                                     int ldw, int ncols, float* ws, Epi epi) {
  for (int c0 = 0; c0 < ncols; c0 += CB) {
    const int cb = min(CB, ncols - c0);
    __syncthreads();
    const int per_row = cb / 8;
    for (int i = threadIdx.x; i < K * per_row; i += blockDim.x) {
      const int k = i / per_row, j = (i % per_row) * 8;
      load8(ws + k * cb + j, W + static_cast<size_t>(k) * ldw + c0 + j);
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
        for (int i = 0; i < RT; ++i) a[i] = a0[i * lda + k];
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

// out = cd((h - mean) * rsqrt(var + eps) * scale + bias), fp32, one warp a row
template <typename T>
__device__ void layer_norm(const float* hs, float* out, int np, int E, int ld,
                           const float* __restrict__ scale, const float* __restrict__ bias) {
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
    for (int c = lane; c < E; c += 32) out[r * ld + c] = rnd<T>((h[c] - mean) * rs * scale[c] + bias[c]);
  }
}

// ao = cd(softmax(q k^T * scale + mask) v) per history and head, fp32; one
// warp per (history, head, query), one key per lane.
template <typename T>
__device__ void attention(const float* qs, int ldq, float* ao, int lda, const float* mask_s,
                          int tb, int S, int E, int H, float scale) {
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

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
encode_fwd_kernel(const T* __restrict__ x, const float* __restrict__ amask, Weights w,
                  T* __restrict__ out, int B, int S, int E, int H, int L, int tb, float scale) {
  extern __shared__ __align__(16) float smem_f[];
  const int n = tb * S, np = pad_rows(n);
  const int ldh = E + 1, ldq = 3 * E + 1, ldf = E + 1;
  float* ws = smem_f;                                  // weight stage (K x CB)
  float* hs = ws + static_cast<size_t>(E) * CB;        // fp32 stream (np x ldh)
  float* as = hs + static_cast<size_t>(np) * ldh;      // product operand: hn1, ao, hn2
  float* qs = as + static_cast<size_t>(np) * ldh;      // qkv (np x ldq)
  float* f1 = qs;                                      // FFN: hidden chunk (np x ldf)
  float* f2 = qs + static_cast<size_t>(np) * ldf;      //      f1 W2 partial sums
  float* mask_s = qs + static_cast<size_t>(np) * ldq;  // (tb, S) additive key mask

  const size_t g0 = static_cast<size_t>(blockIdx.x) * n;  // first global row
  const size_t rows = static_cast<size_t>(B) * S;
  for (int i = threadIdx.x; i < np * E; i += blockDim.x) {
    const int r = i / E, c = i % E;
    const size_t g = g0 + r;
    hs[r * ldh + c] = (r < n && g < rows) ? to_f(x[g * E + c]) : 0.f;
  }
  for (int r = threadIdx.x; r < n; r += blockDim.x)
    mask_s[r] = g0 + r < rows ? amask[g0 + r] : kNegInf;

  const int E3 = 3 * E, E4 = 4 * E;
  for (int li = 0; li < L; ++li) {
    const T* qkv_w = static_cast<const T*>(w.qkv_w) + static_cast<size_t>(li) * E * E3;
    const float* qkv_b = w.qkv_b + li * E3;
    const T* proj_w = static_cast<const T*>(w.proj_w) + static_cast<size_t>(li) * E * E;
    const float* proj_b = w.proj_b + li * E;
    const T* ffn1_w = static_cast<const T*>(w.ffn1_w) + static_cast<size_t>(li) * E * E4;
    const float* ffn1_b = w.ffn1_b + li * E4;
    const T* ffn2_w = static_cast<const T*>(w.ffn2_w) + static_cast<size_t>(li) * E4 * E;
    const float* ffn2_b = w.ffn2_b + li * E;

    // ---- attention branch ----
    __syncthreads();  // h complete
    layer_norm<T>(hs, as, np, E, ldh, w.ln1_s + li * E, w.ln1_b + li * E);
    gemm<T>(as, ldh, np, E, qkv_w, E3, E3, ws,
            [&](int r, int c, float acc) { qs[r * ldq + c] = acc + qkv_b[c]; });
    __syncthreads();  // qkv complete; hn1 dead
    attention<T>(qs, ldq, as, ldh, mask_s, tb, S, E, H, scale);
    gemm<T>(as, ldh, np, E, proj_w, E, E, ws,
            [&](int r, int c, float acc) { hs[r * ldh + c] = hs[r * ldh + c] + (acc + proj_b[c]); });
    __syncthreads();  // h1 complete; ao dead

    // ---- FFN branch: the hidden layer E columns at a time ----
    layer_norm<T>(hs, as, np, E, ldh, w.ln2_s + li * E, w.ln2_b + li * E);
    for (int ch = 0; ch < 4; ++ch) {
      gemm<T>(as, ldh, np, E, ffn1_w + ch * E, E4, E, ws, [&](int r, int c, float acc) {
        f1[r * ldf + c] = rnd<T>(fmaxf(acc + ffn1_b[ch * E + c], 0.f));
      });
      gemm<T>(f1, ldf, np, E, ffn2_w + static_cast<size_t>(ch) * E * E, E, E, ws,
              [&](int r, int c, float acc) {
                f2[r * ldf + c] = ch == 0 ? acc : f2[r * ldf + c] + acc;
              });
    }
    __syncthreads();  // f2 complete
    for (int i = threadIdx.x; i < np * E; i += blockDim.x) {
      const int r = i / E, c = i % E;
      hs[r * ldh + c] = hs[r * ldh + c] + (f2[r * ldf + c] + ffn2_b[c]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n * E; i += blockDim.x) {
    const int r = i / E, c = i % E;
    if (g0 + r < rows) out[(g0 + r) * E + c] = from_f<T>(hs[r * ldh + c]);
  }
}

// The largest count of histories a block can hold, at most kMaxTB; 0 if
// not even one fits.
inline int tile_histories(int S, int E) {
  for (int tb = kMaxTB; tb >= 1; --tb)
    if (smem_floats(tb, S, E) * sizeof(float) <= kMaxSmem) return tb;
  return 0;
}

template <typename T>
static int launch(const void* x, const float* amask, const Weights& w, void* out, int B, int S,
                  int E, int H, int L, float scale, cudaStream_t stream) {
  const int tb = tile_histories(S, E);
  if (tb == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_floats(tb, S, E) * sizeof(float);
  auto kern = encode_fwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<(B + tb - 1) / tb, kThreads, smem, stream>>>(
      static_cast<const T*>(x), amask, w, static_cast<T*>(out), B, S, E, H, L, tb, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace enc
}  // namespace ctr

// Histories a block holds at (S, E); 0 outside the kernel's envelope.
extern "C" int sasrec_encode_tile(int S, int E) {
  if (S < 1 || S > ctr::enc::kMaxS || E % 32 != 0 || E < 32 || E > 128) return 0;
  return ctr::enc::tile_histories(S, E);
}

// x (B*S, E) and out (B*S, E) in the compute dtype (bf16 when is_bf16, else
// fp32); amask (B, S) fp32, -1e9 at pad keys; the 12 stacked weights in the
// order qkv_w (L,E,3E), qkv_b (L,3E), proj_w (L,E,E), proj_b (L,E), ln1_s,
// ln1_b (L,E), ffn1_w (L,E,4E), ffn1_b (L,4E), ffn2_w (L,4E,E), ffn2_b, ln2_s,
// ln2_b (L,E): the four matrices in the compute dtype, the rest fp32. scale
// is 1/sqrt(E/H). Requires 1 <= S <= 32, E % 32 == 0, 32 <= E <= 128,
// E % H == 0, L >= 1 and 16-byte aligned pointers. Returns a cudaError_t.
extern "C" int sasrec_encode_fwd(const void* x, const float* amask, const void* qkv_w,
                                 const float* qkv_b, const void* proj_w, const float* proj_b,
                                 const float* ln1_s, const float* ln1_b, const void* ffn1_w,
                                 const float* ffn1_b, const void* ffn2_w, const float* ffn2_b,
                                 const float* ln2_s, const float* ln2_b, void* out, int B, int S,
                                 int E, int H, int L, float scale, int is_bf16, void* stream) {
  if (sasrec_encode_tile(S, E) == 0 || H < 1 || E % H != 0 || L < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const ctr::enc::Weights w{qkv_w, qkv_b, proj_w, proj_b, ln1_s, ln1_b,
                            ffn1_w, ffn1_b, ffn2_w, ffn2_b, ln2_s, ln2_b};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return ctr::enc::launch<__nv_bfloat16>(x, amask, w, out, B, S, E, H, L, scale, s);
  return ctr::enc::launch<float>(x, amask, w, out, B, S, E, H, L, scale, s);
}
