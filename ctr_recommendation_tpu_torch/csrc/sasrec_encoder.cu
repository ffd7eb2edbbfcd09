// SASRec transformer-encoder forward for Hopper (sm_90a).
//
// Replaces the TPU kernel ctr_recommendation_tpu/ops/pallas/sasrec_encoder.py
// ::_fwd_kernel (:220). For each history of S steps (pos-embedded, pad rows
// zeroed by the wrapper) it runs L pre-LayerNorm blocks:
//
//   hn1 = cd(LN1(h));  qkv = hn1 Wqkv + bqkv                 (fp32, not rounded)
//   per head: p = softmax(q k^T / sqrt(D) + mask);  ao = cd(p v)
//   h  += drop0(ao Wproj + bproj)
//   hn2 = cd(LN2(h));  f1 = cd(relu(hn2 W1 + b1));  h += drop1(f1 W2 + b2)
//
// The stream h is fp32 for all L layers (x upcast once, the output rounded
// once to x's dtype); LayerNorm (biased variance, eps 1e-6), the attention
// products and the softmax are fp32; the four weight products take operands
// rounded to the compute dtype cd and accumulate in fp32; biases are fp32.
// The mask is additive (-1e9 at pad keys, never -inf), so a history that is
// all pad gives a uniform softmax. Pad rows are not re-zeroed between layers:
// masked keys keep them out of every real row, and the wrapper zeroes them
// on output. In training, drop0/drop1 are the residual dropout of the TPU
// kernel (:190-204), drawn from the counter-based Philox mask of common.cuh
// keyed by (seed, global token, column, layer, branch); at rate 0 they are
// the identity and the seed is never read.
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

#include "sasrec_encoder.cuh"

namespace ctr {
namespace enc {

// Shared memory of a block of tb histories, in floats: the weight stage,
// then h, the product operand and qkv (which the FFN reuses), then the mask.
__host__ __device__ inline size_t smem_floats(int tb, int S, int E) {
  const size_t np = pad_rows(tb * S);
  return static_cast<size_t>(E) * CB + np * (2 * (E + 1) + 3 * E + 1) + pad_rows(tb * S);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
encode_fwd_kernel(const T* __restrict__ x, const float* __restrict__ amask, Weights w,
                  Dropout drop, T* __restrict__ out, int B, int S, int E, int H, int L, int tb,
                  float scale) {
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

  const size_t g0 = static_cast<size_t>(blockIdx.x) * n;  // first global row (token)
  const size_t rows = static_cast<size_t>(B) * S;
  const uint64_t seed = drop.read_seed();
  for (int i = threadIdx.x; i < np * E; i += blockDim.x) {
    const int r = i / E, c = i % E;
    const size_t g = g0 + r;
    hs[r * ldh + c] = (r < n && g < rows) ? to_f(x[g * E + c]) : 0.f;
  }
  for (int r = threadIdx.x; r < n; r += blockDim.x)
    mask_s[r] = g0 + r < rows ? amask[g0 + r] : kNegInf;

  const int E4 = 4 * E;
  for (int li = 0; li < L; ++li) {
    const Layer<T> lw(w, li, E);

    // ---- attention branch ----
    __syncthreads();  // h complete
    layer_norm<T>(hs, as, np, E, ldh, lw.ln1_s, lw.ln1_b);
    gemm<T>(as, ldh, np, E, lw.qkv_w, 3 * E, 3 * E, ws,
            [&](int r, int c, float acc) { qs[r * ldq + c] = acc + lw.qkv_b[c]; });
    __syncthreads();  // qkv complete; hn1 dead
    attention<T>(qs, ldq, as, ldh, mask_s, tb, S, E, H, scale);
    gemm<T>(as, ldh, np, E, lw.proj_w, E, E, ws, [&](int r, int c, float acc) {
      hs[r * ldh + c] = hs[r * ldh + c] + dropped(acc + lw.proj_b[c], drop.rate, drop.inv_keep,
                                                  seed, g0 + r, c, li, 0);
    });
    __syncthreads();  // h1 complete; ao dead

    // ---- FFN branch: the hidden layer E columns at a time ----
    layer_norm<T>(hs, as, np, E, ldh, lw.ln2_s, lw.ln2_b);
    for (int ch = 0; ch < 4; ++ch) {
      gemm<T>(as, ldh, np, E, lw.ffn1_w + ch * E, E4, E, ws, [&](int r, int c, float acc) {
        f1[r * ldf + c] = rnd<T>(fmaxf(acc + lw.ffn1_b[ch * E + c], 0.f));
      });
      gemm<T>(f1, ldf, np, E, lw.ffn2_w + static_cast<size_t>(ch) * E * E, E, E, ws,
              [&](int r, int c, float acc) {
                f2[r * ldf + c] = ch == 0 ? acc : f2[r * ldf + c] + acc;
              });
    }
    __syncthreads();  // f2 complete
    for (int i = threadIdx.x; i < np * E; i += blockDim.x) {
      const int r = i / E, c = i % E;
      hs[r * ldh + c] = hs[r * ldh + c] + dropped(f2[r * ldf + c] + lw.ffn2_b[c], drop.rate,
                                                  drop.inv_keep, seed, g0 + r, c, li, 1);
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
static int launch(const void* x, const float* amask, const Weights& w, const Dropout& drop,
                  void* out, int B, int S, int E, int H, int L, float scale,
                  cudaStream_t stream) {
  const int tb = tile_histories(S, E);
  if (tb == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_floats(tb, S, E) * sizeof(float);
  auto kern = encode_fwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<(B + tb - 1) / tb, kThreads, smem, stream>>>(
      static_cast<const T*>(x), amask, w, drop, static_cast<T*>(out), B, S, E, H, L, tb, scale);
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
// is 1/sqrt(E/H). Dropout on the two residual branches when rate > 0: seed
// is then a device pointer to one int64 and inv_keep fp32(1 / (1 - rate));
// at rate 0 seed is not read and the results are those of an eval launch.
// Requires 1 <= S <= 32, E % 32 == 0, 32 <= E <= 128, E % H == 0, L >= 1,
// 0 <= rate < 1 and 16-byte aligned pointers. Returns a cudaError_t.
extern "C" int sasrec_encode_fwd(const void* x, const float* amask, const void* qkv_w,
                                 const float* qkv_b, const void* proj_w, const float* proj_b,
                                 const float* ln1_s, const float* ln1_b, const void* ffn1_w,
                                 const float* ffn1_b, const void* ffn2_w, const float* ffn2_b,
                                 const float* ln2_s, const float* ln2_b, const int64_t* seed,
                                 void* out, int B, int S, int E, int H, int L, float scale,
                                 float rate, float inv_keep, int is_bf16, void* stream) {
  if (sasrec_encode_tile(S, E) == 0 || H < 1 || E % H != 0 || L < 1 || B < 1 ||
      !(rate >= 0.f && rate < 1.f) || (rate > 0.f && seed == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const ctr::enc::Weights w{qkv_w, qkv_b, proj_w, proj_b, ln1_s, ln1_b,
                            ffn1_w, ffn1_b, ffn2_w, ffn2_b, ln2_s, ln2_b};
  const ctr::enc::Dropout drop{seed, rate, inv_keep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return ctr::enc::launch<__nv_bfloat16>(x, amask, w, drop, out, B, S, E, H, L, scale, s);
  return ctr::enc::launch<float>(x, amask, w, drop, out, B, S, E, H, L, scale, s);
}
