// SASRec transformer-encoder forward for Hopper (sm_90a), token-major.
//
// Replaces the TPU kernel ctr_recommendation_tpu/ops/pallas/sasrec_encoder.py
// ::_fwd_kernel (:220). Over all N = B*S tokens of the pos-embedded
// histories (pad rows zeroed by the wrapper) it runs L pre-LayerNorm blocks:
//
//   hn1 = cd(LN1(h));  qkv = hn1 Wqkv + bqkv                 (fp32, not rounded)
//   per history and head: p = softmax(q k^T / sqrt(D) + mask);  ao = cd(p v)
//   h  += drop0(ao Wproj + bproj)
//   hn2 = cd(LN2(h));  f1 = cd(relu(hn2 W1 + b1));  h += drop1(f1 W2 + b2)
//
// The stream h is fp32 for all L layers (x upcast once, the output rounded
// once to x's dtype); LayerNorm (biased variance, eps 1e-6), the attention
// products and the softmax are fp32; the four weight products take operands
// rounded to the compute dtype cd and accumulate in fp32; biases are fp32.
// The mask is additive (-1e9 at pad keys), so an all-pad history gives a
// uniform softmax; pad rows are not re-zeroed between layers (the wrapper
// zeroes them on output). drop0/drop1 are the residual dropout of the TPU
// kernel (:190-204), drawn from the counter-based Philox mask of common.cuh
// keyed by (seed, global token, column, layer, branch); at rate 0 they are
// the identity and the seed is never read.
//
// Bound on an H100: operations. At B=8192, S=20, E=128, one layer, the
// forward is 66.1 GFLOP against ~85 MB of x, the output and the weights. Of
// the 24 E^2 + 4 S E flops a token a layer, the attention's 4 S E keep fp32
// accuracy (the precision contract) as 3xTF32 on the tensor cores, three
// TF32 operations each at 495 TFLOP/s: at S=200 they are 168 GFLOP, 1.02
// ms, beside 644 GFLOP of bf16 products, 0.65 ms.
// Design: one launch per building block over all tokens, in place of a
// block that owned whole histories. The four products are the tile product
// of tile_mma.cuh (bf16: mma.sync on the tensor cores) with the bias, ReLU,
// dropout and residual fused into their epilogues; LayerNorm is a warp a
// row; attention a block per (history, head, 64 queries) on the tensor
// cores, its keys streamed in tiles, so that any S and any head width run
// (the staged fp32 CUDA-core kernels where attn_staged says so). Widths
// E % 32 != 0 or E / H % 4 != 0 run zero-padded (Widths in
// sasrec_encoder.cuh; the wrapper pads x and the weights). Between launches the
// token-major intermediates (fp32 h and qkv, cd hn, ao and f1: 0.59 GB at
// B=8192, E=128, bf16) live in a workspace the wrapper allocates. Each is
// written once and read once or twice: 1.68 GB of traffic a layer at that
// shape, 0.50 ms at 3.35 TB/s, the floor this design sets (a fused kernel
// would keep them on chip). Launches: 1 + 7 L (the upcast of x, then LN1,
// qkv, attention, proj, LN2, ffn1, ffn2 per layer; the last ffn2 writes
// the output in cd). The wrapper cuts a call of any batch into chunks of
// rows (ops/cuda/sasrec_encoder.py plan_chunks), one call here a chunk,
// each within in_envelope's rows and a bounded workspace.

#include "sasrec_encoder.cuh"

namespace ctr {
namespace enc {

template <typename T>
struct FwdWork {
  float* h;
  T* hn;
  float* qkv;
  T* ao;
  T* f1;

  FwdWork(Carve& cv, size_t N, int E) {
    h = cv.take<float>(N * E);
    hn = cv.take<T>(N * E);
    qkv = cv.take<float>(N * 3 * E);
    ao = cv.take<T>(N * E);
    f1 = cv.take<T>(N * 4 * E);
  }
};

#define TRY(call)                         \
  do {                                    \
    const int rc_ = (call);               \
    if (rc_ != 0) return rc_;             \
  } while (0)

// x and out (B*S, Ep) and the weights at the padded widths (Widths); E the
// true width, for LayerNorm.
template <typename T>
int encode_fwd(const T* x, const float* amask, const Weights& w, const Dropout& drop, T* out,
               int B, int S, int E, int H, int L, float scale, char* workspace,
               cudaStream_t s) {
  const int N = B * S;
  const Widths wd = widths(E, H);
  const int Ep = wd.Ep;
  Carve cv{workspace};
  const FwdWork<T> wk(cv, N, Ep);
  TRY(launch_convert(x, wk.h, static_cast<size_t>(N) * Ep, s));
  for (int li = 0; li < L; ++li) {
    const Layer<T> lw(w, li, Ep);
    TRY(launch_ln_fwd<T>(wk.h, N, Ep, E, lw.ln1_s, lw.ln1_b, wk.hn, nullptr, nullptr, s));
    TRY((mma::launch_product<T, false, true>(wk.hn, lw.qkv_w, N, 3 * Ep, Ep, 1, Ep,
                                             EpiBias{wk.qkv, 3 * Ep, lw.qkv_b}, s)));
    TRY(launch_attention_fwd<T>(wk.qkv, amask, wk.ao, nullptr, nullptr, nullptr, B, S, Ep, H,
                                wd.Dp, scale, s));
    TRY((mma::launch_product<T, false, true>(
        wk.ao, lw.proj_w, N, Ep, Ep, 1, Ep,
        EpiResidual<T>{wk.h, nullptr, Ep, lw.proj_b, drop, li, 0}, s)));
    TRY(launch_ln_fwd<T>(wk.h, N, Ep, E, lw.ln2_s, lw.ln2_b, wk.hn, nullptr, nullptr, s));
    TRY((mma::launch_product<T, false, true>(wk.hn, lw.ffn1_w, N, 4 * Ep, Ep, 1, Ep,
                                             EpiRelu<T>{wk.f1, 4 * Ep, lw.ffn1_b}, s)));
    TRY((mma::launch_product<T, false, true>(
        wk.f1, lw.ffn2_w, N, Ep, 4 * Ep, 1, 4 * Ep,
        EpiResidual<T>{wk.h, li == L - 1 ? out : nullptr, Ep, lw.ffn2_b, drop, li, 1}, s)));
  }
  return 0;
}

// One product hn W of the forward with epilogue `epi` (1 bias, 2 relu,
// 3 residual in place into out_f, 4 residual out_f + ... rounded into out_c).
template <typename T>
int product_nn(int epi, const T* A, const T* B, int M, int N, int K, const float* bias,
               float* out_f, void* out_c, const Dropout& drop, int layer, int branch,
               cudaStream_t s) {
  T* oc = static_cast<T*>(out_c);
  switch (epi) {
    case 1:
      return mma::launch_product<T, false, true>(A, B, M, N, K, 1, K, EpiBias{out_f, N, bias}, s);
    case 2:
      return mma::launch_product<T, false, true>(A, B, M, N, K, 1, K, EpiRelu<T>{oc, N, bias},
                                                 s);
    case 3:
    case 4:
      return mma::launch_product<T, false, true>(
          A, B, M, N, K, 1, K,
          EpiResidual<T>{out_f, epi == 4 ? oc : nullptr, N, bias, drop, layer, branch}, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace enc
}  // namespace ctr

using ctr::enc::Dropout;

// Whether both entry points take (S, E, H, L): S >= 1, E >= 1, H >= 1, E %
// H == 0, L >= 1 (and, at a call, in_envelope's grid rows).
// ops/cuda/sasrec_encoder.py::fits is the same function of the same shapes.
extern "C" int sasrec_encoder_fits(int S, int E, int H, int L) {
  return ctr::enc::shapes_ok(S, E, H, L) ? 1 : 0;
}

// The padded stream width Ep and head width Dp the kernels run (E, H) at
// (Widths), as Ep * 1024 + Dp; 0 outside the envelope.
extern "C" int sasrec_encoder_widths(int E, int H) {
  if (!ctr::enc::shapes_ok(1, E, H, 1)) return 0;
  const ctr::enc::Widths w = ctr::enc::widths(E, H);
  return w.Ep * 1024 + w.Dp;
}

// Whether the attention runs staged (1) or streamed (0) at (S, E, H).
extern "C" int sasrec_attention_staged(int S, int E, int H) {
  return ctr::enc::attn_staged(S, ctr::enc::widths(E, H).Dp) ? 1 : 0;
}

// Bytes of workspace sasrec_encode_fwd needs at (B, S, E, H).
extern "C" size_t sasrec_encode_fwd_workspace(int B, int S, int E, int H, int is_bf16) {
  ctr::enc::Carve cv{nullptr};
  const size_t N = static_cast<size_t>(B) * S;
  const int Ep = ctr::enc::widths(E, H).Ep;
  if (is_bf16)
    (void)ctr::enc::FwdWork<__nv_bfloat16>(cv, N, Ep);
  else
    (void)ctr::enc::FwdWork<float>(cv, N, Ep);
  return cv.used;
}

// x (B*S, Ep) and out (B*S, Ep) in the compute dtype (bf16 when is_bf16,
// else fp32), at the padded widths (Ep, Dp) = Widths(E, H), the real columns
// first; amask (B, S) fp32, -1e9 at pad keys; the 12 stacked weights padded
// with zeros (the layout of Widths) in the order qkv_w (L,Ep,3Ep), qkv_b
// (L,3Ep), proj_w (L,Ep,Ep), proj_b (L,Ep), ln1_s, ln1_b (L,Ep), ffn1_w
// (L,Ep,4Ep), ffn1_b (L,4Ep), ffn2_w (L,4Ep,Ep), ffn2_b, ln2_s, ln2_b (L,Ep):
// the four matrices in the compute dtype, the rest fp32. E and H are the true
// width and heads; scale is 1/sqrt(E/H). Dropout on the two residual branches when rate > 0: seed
// is then a device pointer to one int64, inv_keep fp32(1 / (1 - rate)) and
// token0 the global token of row 0 (Dropout).
// workspace holds sasrec_encode_fwd_workspace bytes. Requires
// sasrec_encoder_fits(S, E, H, L), B >= 1, 0 <= rate < 1 and 16-byte aligned
// pointers. Enqueues 1 + 7 L launches on `stream`; returns
// the first cudaError_t that is not 0.
extern "C" int sasrec_encode_fwd(const void* x, const float* amask, const void* qkv_w,
                                 const float* qkv_b, const void* proj_w, const float* proj_b,
                                 const float* ln1_s, const float* ln1_b, const void* ffn1_w,
                                 const float* ffn1_b, const void* ffn2_w, const float* ffn2_b,
                                 const float* ln2_s, const float* ln2_b, const int64_t* seed,
                                 void* out, void* workspace, int B, int S, int E, int H, int L,
                                 float scale, float rate, float inv_keep, unsigned token0,
                                 int is_bf16, void* stream) {
  if (!ctr::enc::in_envelope(B, S, E, H, L) || !ctr::enc::dropout_ok(seed, rate))
    return static_cast<int>(cudaErrorInvalidValue);
  const ctr::enc::Weights w{qkv_w, qkv_b, proj_w, proj_b, ln1_s, ln1_b,
                            ffn1_w, ffn1_b, ffn2_w, ffn2_b, ln2_s, ln2_b};
  const Dropout drop{seed, rate, inv_keep, token0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* ws = static_cast<char*>(workspace);
  if (is_bf16)
    return ctr::enc::encode_fwd<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(x), amask, w, drop, static_cast<__nv_bfloat16*>(out),
        B, S, E, H, L, scale, ws, s);
  return ctr::enc::encode_fwd<float>(static_cast<const float*>(x), amask, w, drop,
                                     static_cast<float*>(out), B, S, E, H, L, scale, ws, s);
}

// ---- the forward's blocks one by one, for the checks on the card ----

// C = A B, A (M, K) and B (K, N) in the compute dtype, with epilogue epi:
// 1 out_f = C + bias; 2 out_c = cd(relu(C + bias)); 3 out_f += drop(C +
// bias) in place; 4 out_c = cd(out_f + drop(C + bias)). M any, N and K % 32
// == 0. One launch.
extern "C" int sasrec_product_fwd(int epi, const void* A, const void* B, int M, int N, int K,
                                  const float* bias, float* out_f, void* out_c,
                                  const int64_t* seed, float rate, float inv_keep,
                                  unsigned token0, int layer, int branch, int is_bf16,
                                  void* stream) {
  if (M < 1 || N % 32 || K % 32 || N < 32 || K < 32 || !ctr::enc::dropout_ok(seed, rate))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dropout drop{seed, rate, inv_keep, token0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return ctr::enc::product_nn<__nv_bfloat16>(
        epi, static_cast<const __nv_bfloat16*>(A), static_cast<const __nv_bfloat16*>(B), M, N, K,
        bias, out_f, out_c, drop, layer, branch, s);
  return ctr::enc::product_nn<float>(epi, static_cast<const float*>(A),
                                     static_cast<const float*>(B), M, N, K, bias, out_f, out_c,
                                     drop, layer, branch, s);
}

// out = cd(LN(h)) over the first E of ld columns of (N, ld) fp32 h (the
// rest written 0), and xhat, rstd when not null. One launch.
extern "C" int sasrec_layer_norm(const float* h, int N, int ld, int E, const float* scale,
                                 const float* bias, void* out, float* xhat, float* rstd,
                                 int is_bf16, void* stream) {
  if (N < 1 || E < 1 || ld < E) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return ctr::enc::launch_ln_fwd(h, N, ld, E, scale, bias, static_cast<__nv_bfloat16*>(out),
                                   xhat, rstd, s);
  return ctr::enc::launch_ln_fwd(h, N, ld, E, scale, bias, static_cast<float*>(out), xhat, rstd,
                                 s);
}

// The staged forward (attn_staged_fits(S, D)): ao (B*S, E) in cd and, when P is
// not null, the softmax (B, H, S, S) fp32, from qkv (B*S, 3E) fp32 and amask
// (B, S). One launch.
extern "C" int sasrec_attention_fwd(const float* qkv, const float* amask, void* ao, float* P,
                                    int B, int S, int E, int H, int D, float scale, int is_bf16,
                                    void* stream) {
  if (!ctr::enc::attention_block_ok(B, S, E, H, D) || !ctr::enc::attn_staged_fits(S, D))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return ctr::enc::launch_attn_fwd(qkv, amask, static_cast<__nv_bfloat16*>(ao), P, B, S, E, H,
                                     D, scale, s);
  return ctr::enc::launch_attn_fwd(qkv, amask, static_cast<float*>(ao), P, B, S, E, H, D, scale,
                                   s);
}

// The streamed forward, any S and D: ao (B*S, E) in cd and, when not null, o32
// (B*S, E) fp32 and stats (B, H, S) float2 (m, l). One launch.
extern "C" int sasrec_attention_fwd_streamed(const float* qkv, const float* amask, void* ao,
                                             float* o32, float* stats, int B, int S, int E, int H,
                                             int D, float scale, int is_bf16, void* stream) {
  if (!ctr::enc::attention_block_ok(B, S, E, H, D))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* st = reinterpret_cast<float2*>(stats);
  if (is_bf16)
    return ctr::enc::launch_attn_fwd_streamed(qkv, amask, static_cast<__nv_bfloat16*>(ao), o32,
                                              st, B, S, E, H, D, scale, s);
  return ctr::enc::launch_attn_fwd_streamed(qkv, amask, static_cast<float*>(ao), o32, st, B, S, E,
                                            H, D, scale, s);
}
