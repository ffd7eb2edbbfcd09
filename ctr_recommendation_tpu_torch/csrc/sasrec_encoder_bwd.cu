// SASRec transformer-encoder backward for Hopper (sm_90a), token-major.
//
// Replaces the TPU kernel ctr_recommendation_tpu/ops/pallas/sasrec_encoder.py
// ::_bwd_kernel (:238), driven there by _pallas_encode_bwd (:416). Given the
// cotangent g of the encoded history and the forward's input x, it
// recomputes the forward from x through the forward's blocks (the residual
// dropout masks redrawn from the same counter-based Philox keys: seed,
// global token, column, layer, branch), keeping each layer's residues, and
// walks the layers in reverse, as the TPU kernel does:
//
//   FFN:  df2 = drop1(dh);  dW2 = cd(f1)^T cd(df2);  db2 = sum df2
//         dz1 = (cd(df2) cd(W2)^T) * [z1 > 0];  dW1 = cd(hn2)^T cd(dz1);  db1 = sum dz1
//         dh += LN2^T(cd(dz1) cd(W1)^T)                   (dln2 scale, bias summed)
//   attn: da1 = drop0(dh);  dWp = cd(ao)^T cd(da1);  dbp = sum da1
//         dao = cd(da1) cd(Wp)^T;  per head (fp32): dp = dao v^T,
//         dlog = p (dp - sum(dp p)) / sqrt(D);  dq = dlog k;  dk = dlog^T q;  dv = p^T dao
//         (sum(dp p) = dao . o, the attention's fp32 output, where the keys stream)
//         dWqkv = cd(hn1)^T cd(dqkv);  dbqkv = sum dqkv
//         dh += LN1^T(cd(dqkv) cd(Wqkv)^T)                (dln1 scale, bias summed)
//
// cd() is a cast to the compute dtype T; everything else is fp32, and dx is
// rounded once, to T. The 12 weight gradients are fp32; the bias gradients
// are sums of the fp32 values, not of their cd copies.
//
// Bound on an H100: operations. At B=4096, S=20, E=128, one layer, the
// recomputed forward and the two products per weight are 99.2 GFLOP against
// ~64 MB of g, x, dx and the weights and their gradients.
//
// Design: one launch per building block over all N = B*S tokens. The
// transposed products dY W^T read W as stored (ldmatrix without .trans),
// the weight gradients A^T G read both operands token-major (ldmatrix
// .trans) and split the token sum into Z chunks, each writing an fp32
// partial; the column sums (bias gradients, LayerNorm's dscale and dbias)
// write partials over the same chunks, and one reduction a layer sums them
// in chunk order: no atomics, so a repeat launch is bit-identical. Each
// weight gradient takes its own number of chunks, so that its product
// launches about 264 blocks (two an SM) whatever its size: ~17 MB of
// partials a matrix at E=128 and at E=256. The dropout
// gate on dh is fused into the column sum that first reads it, which also
// writes the gated cd operand. The residues of every layer (hn1, xhat1,
// rstd1, qkv, p, ao, xhat2, rstd2, hn2, f1) live in a workspace the wrapper
// allocates: ~370 MB a layer at B=4096, E=128, bf16. The attention's
// residue is the softmax P (B H S^2 floats) where the staged kernels take
// the history (attn_staged), else the fp32 output o and each query's (m, l)
// (B H S float2), from which the streamed backward rebuilds P a key tile at
// a time: at S=200, E=128, H=2, B=4096 that is 0.42 GB a layer where P
// would be 1.31 GB. Widths off the kernels' multiples run zero-padded
// (Widths), as in the forward. The recompute skips the last layer's ffn2
// product, which no gradient reads.
// Launches: 25 L + 1 (the upcast of x, 7 L - 1 recomputing, the upcast of
// g, 18 a layer in reverse including the reduction). The wrapper runs a
// call of any batch as chunks of rows, one call here a chunk; a later
// chunk's reductions add its gradients to the earlier chunks' (accumulate).

#include "sasrec_encoder.cuh"

namespace ctr {
namespace enc {

template <typename T>
struct Residues {  // one layer's, kept by the recompute
  T* hn1;
  float* xhat1;
  float* rstd1;
  float* qkv;
  float* p;       // staged: the softmax (B, H, S, S)
  float* o32;     // streamed: the attention's fp32 output (N, Ep)
  float2* stats;  // streamed: each query's (m, l) (B, H, S)
  T* ao;
  float* xhat2;
  float* rstd2;
  T* hn2;
  T* f1;
};

template <typename T>
struct BwdWork {
  std::vector<Residues<T>> res;
  float* h;      // the stream, then (reverse walk) unused
  float* dh;     // the gradient stream
  T* gated;      // df2 or da1 in cd
  float* dz;     // dz1 fp32 (N, 4E); dqkv fp32 (N, 3E)
  T* dz_c;       // their cd copies
  float* dn;     // dn2, dao, dn1 (N, E)
  float* part;   // one layer's weight-gradient partials (GradLayout)

  // E is the padded width Ep; staged whether the attention runs staged
  BwdWork(Carve& cv, int B, int S, int E, int H, int L, bool staged) {
    const size_t N = static_cast<size_t>(B) * S, NE = N * E;
    res.resize(L);
    for (int li = 0; li < L; ++li) {
      Residues<T>& r = res[li];
      r.hn1 = cv.take<T>(NE);
      r.xhat1 = cv.take<float>(NE);
      r.rstd1 = cv.take<float>(N);
      r.qkv = cv.take<float>(3 * NE);
      r.p = staged ? cv.take<float>(static_cast<size_t>(B) * H * S * S) : nullptr;
      r.o32 = staged ? nullptr : cv.take<float>(NE);
      r.stats = staged ? nullptr : cv.take<float2>(static_cast<size_t>(B) * H * S);
      r.ao = cv.take<T>(NE);
      r.xhat2 = cv.take<float>(NE);
      r.rstd2 = cv.take<float>(N);
      r.hn2 = cv.take<T>(NE);
      r.f1 = cv.take<T>(4 * NE);
    }
    h = cv.take<float>(NE);
    dh = cv.take<float>(NE);
    gated = cv.take<T>(NE);
    dz = cv.take<float>(4 * NE);
    dz_c = cv.take<T>(4 * NE);
    dn = cv.take<float>(NE);
    part = cv.take<float>(grad_layout(static_cast<int>(N), E, L, 0).part_total);
  }
};

#define TRY(call)             \
  do {                        \
    const int rc_ = (call);   \
    if (rc_ != 0) return rc_; \
  } while (0)

// g, x and dx (B*S, Ep) and the weights at the padded widths (Widths); E
// the true width, for LayerNorm.
template <typename T>
int encode_bwd(const T* g, const T* x, const float* amask, const Weights& w, const Dropout& drop,
               T* dx, float* out, int B, int S, int E_true, int H, int L, float scale,
               char* workspace, int accumulate, cudaStream_t s) {
  const int N = B * S;
  const Widths wd = widths(E_true, H);
  const int E = wd.Ep, Dp = wd.Dp;  // the kernels' widths
  const bool staged = attn_staged(S, Dp);
  const size_t NE = static_cast<size_t>(N) * E;
  Carve cv{workspace};
  const BwdWork<T> wk(cv, B, S, E, H, L, staged);

  // ---- the forward, recomputed, keeping each layer's residues ----
  TRY(launch_convert(x, wk.h, NE, s));
  for (int li = 0; li < L; ++li) {
    const Layer<T> lw(w, li, E);
    const Residues<T>& r = wk.res[li];
    TRY(launch_ln_fwd<T>(wk.h, N, E, E_true, lw.ln1_s, lw.ln1_b, r.hn1, r.xhat1, r.rstd1, s));
    TRY((mma::launch_product<T, false, true>(r.hn1, lw.qkv_w, N, 3 * E, E, 1, E,
                                             EpiBias{r.qkv, 3 * E, lw.qkv_b}, s)));
    TRY(launch_attention_fwd<T>(r.qkv, amask, r.ao, r.p, r.o32, r.stats, B, S, E, H, Dp, scale,
                                s));
    TRY((mma::launch_product<T, false, true>(
        r.ao, lw.proj_w, N, E, E, 1, E,
        EpiResidual<T>{wk.h, nullptr, E, lw.proj_b, drop, li, 0}, s)));
    TRY(launch_ln_fwd<T>(wk.h, N, E, E_true, lw.ln2_s, lw.ln2_b, r.hn2, r.xhat2, r.rstd2, s));
    TRY((mma::launch_product<T, false, true>(r.hn2, lw.ffn1_w, N, 4 * E, E, 1, E,
                                             EpiRelu<T>{r.f1, 4 * E, lw.ffn1_b}, s)));
    if (li < L - 1)
      TRY((mma::launch_product<T, false, true>(
          r.f1, lw.ffn2_w, N, E, 4 * E, 1, 4 * E,
          EpiResidual<T>{wk.h, nullptr, E, lw.ffn2_b, drop, li, 1}, s)));
  }

  // ---- the reverse walk ----
  TRY(launch_convert(g, wk.dh, NE, s));
  for (int li = L - 1; li >= 0; --li) {
    const Layer<T> lw(w, li, E);
    const Residues<T>& r = wk.res[li];
    const GradLayout lay = grad_layout(N, E, L, li);
    float* part = wk.part;
    auto pk = [&](int k) { return part + lay.base[k]; };  // gradient k's partials
    auto mat = [&](int k, int ld) { return EpiPartial{pk(k), ld, lay.size[k]}; };
    const Split vec = lay.split[1];  // the column sums' split
    const size_t vs = E;             // and their stride, for the E-wide ones
    // FFN branch
    TRY((launch_column_sums<T, kGate>(wk.dh, nullptr, wk.gated, drop, li, 1, N, E, vec, pk(9),
                                      nullptr, vs, s)));
    TRY((mma::launch_product<T, true, true>(r.f1, wk.gated, 4 * E, E, N, lay.split[8].count,
                                            lay.split[8].chunk, mat(8, E), s)));
    TRY((mma::launch_product<T, false, false>(wk.gated, lw.ffn2_w, N, 4 * E, E, 1, E,
                                              EpiGate<T>{r.f1, wk.dz, wk.dz_c, 4 * E}, s)));
    TRY((launch_column_sums<T, kSum>(wk.dz, nullptr, nullptr, drop, li, 1, N, 4 * E, vec, pk(7),
                                     nullptr, 4 * vs, s)));
    TRY((mma::launch_product<T, true, true>(r.hn2, wk.dz_c, E, 4 * E, N, lay.split[6].count,
                                            lay.split[6].chunk, mat(6, 4 * E), s)));
    TRY((mma::launch_product<T, false, false>(wk.dz_c, lw.ffn1_w, N, E, 4 * E, 1, 4 * E,
                                              EpiStore{wk.dn, E}, s)));
    TRY((launch_column_sums<T, kLnSums>(wk.dn, r.xhat2, nullptr, drop, li, 1, N, E, vec, pk(10),
                                        pk(11), vs, s)));
    TRY(launch_ln_bwd<float>(wk.dn, r.xhat2, r.rstd2, lw.ln2_s, wk.dh, wk.dh, N, E, E_true, s));
    // attention branch
    TRY((launch_column_sums<T, kGate>(wk.dh, nullptr, wk.gated, drop, li, 0, N, E, vec, pk(3),
                                      nullptr, vs, s)));
    TRY((mma::launch_product<T, true, true>(r.ao, wk.gated, E, E, N, lay.split[2].count,
                                            lay.split[2].chunk, mat(2, E), s)));
    TRY((mma::launch_product<T, false, false>(wk.gated, lw.proj_w, N, E, E, 1, E,
                                              EpiStore{wk.dn, E}, s)));
    if (staged)
      TRY(launch_attn_bwd<T>(r.qkv, r.p, wk.dn, wk.dz, wk.dz_c, B, S, E, H, Dp, scale, s));
    else
      TRY(launch_attn_bwd_streamed<T>(r.qkv, amask, r.o32, r.stats, wk.dn, wk.dz, wk.dz_c, B, S,
                                      E, H, Dp, scale, s));
    TRY((launch_column_sums<T, kSum>(wk.dz, nullptr, nullptr, drop, li, 0, N, 3 * E, vec, pk(1),
                                     nullptr, 3 * vs, s)));
    TRY((mma::launch_product<T, true, true>(r.hn1, wk.dz_c, E, 3 * E, N, lay.split[0].count,
                                            lay.split[0].chunk, mat(0, 3 * E), s)));
    TRY((mma::launch_product<T, false, false>(wk.dz_c, lw.qkv_w, N, E, 3 * E, 1, 3 * E,
                                              EpiStore{wk.dn, E}, s)));
    TRY((launch_column_sums<T, kLnSums>(wk.dn, r.xhat1, nullptr, drop, li, 0, N, E, vec, pk(4),
                                        pk(5), vs, s)));
    if (li > 0)
      TRY(launch_ln_bwd<float>(wk.dn, r.xhat1, r.rstd1, lw.ln1_s, wk.dh, wk.dh, N, E, E_true, s));
    else
      TRY(launch_ln_bwd<T>(wk.dn, r.xhat1, r.rstd1, lw.ln1_s, wk.dh, dx, N, E, E_true, s));
    TRY(launch_reduce(part, lay, out, s, accumulate));
  }
  return 0;
}

}  // namespace enc
}  // namespace ctr

using ctr::enc::Dropout;

// Bytes of workspace sasrec_encode_bwd needs at (B, S, E, H, L); 0 outside
// the envelope.
extern "C" size_t sasrec_encode_bwd_workspace(int B, int S, int E, int H, int L, int is_bf16) {
  if (!ctr::enc::in_envelope(B, S, E, H, L)) return 0;
  ctr::enc::Carve cv{nullptr};
  const ctr::enc::Widths wd = ctr::enc::widths(E, H);
  const bool staged = ctr::enc::attn_staged(S, wd.Dp);
  if (is_bf16)
    (void)ctr::enc::BwdWork<__nv_bfloat16>(cv, B, S, wd.Ep, H, L, staged);
  else
    (void)ctr::enc::BwdWork<float>(cv, B, S, wd.Ep, H, L, staged);
  return cv.used;
}

// g, x and dx (B*S, Ep) in the compute dtype (bf16 when is_bf16, else fp32),
// at the padded widths as for sasrec_encode_fwd; amask (B, S) fp32; the 12
// stacked weights padded as for sasrec_encode_fwd; seed, rate, inv_keep and
// token0 the forward's. Writes dx and out, the 12 fp32 weight gradients (L,
// ...) of the padded weights one after another in the weights' order; with
// accumulate, each layer's reduction adds them to what out holds instead (a
// later chunk of rows of one call, the chunks' sums added in chunk order:
// no launch more). workspace holds sasrec_encode_bwd_workspace bytes.
// Requires the forward's envelope and 16-byte aligned pointers. Enqueues
// 25 L + 1 launches on `stream`; returns the first cudaError_t that is not 0.
extern "C" int sasrec_encode_bwd(const void* g, const void* x, const float* amask,
                                 const void* qkv_w, const float* qkv_b, const void* proj_w,
                                 const float* proj_b, const float* ln1_s, const float* ln1_b,
                                 const void* ffn1_w, const float* ffn1_b, const void* ffn2_w,
                                 const float* ffn2_b, const float* ln2_s, const float* ln2_b,
                                 const int64_t* seed, void* dx, float* out, void* workspace,
                                 int B, int S, int E, int H, int L, float scale, float rate,
                                 float inv_keep, unsigned token0, int is_bf16, int accumulate,
                                 void* stream) {
  if (!ctr::enc::in_envelope(B, S, E, H, L) ||
      !ctr::enc::dropout_ok(seed, rate))
    return static_cast<int>(cudaErrorInvalidValue);
  const ctr::enc::Weights w{qkv_w, qkv_b, proj_w, proj_b, ln1_s, ln1_b,
                            ffn1_w, ffn1_b, ffn2_w, ffn2_b, ln2_s, ln2_b};
  const Dropout drop{seed, rate, inv_keep, token0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* ws = static_cast<char*>(workspace);
  if (is_bf16) {
    using T = __nv_bfloat16;
    return ctr::enc::encode_bwd<T>(static_cast<const T*>(g), static_cast<const T*>(x), amask, w,
                                   drop, static_cast<T*>(dx), out, B, S, E, H, L, scale, ws,
                                   accumulate, s);
  }
  return ctr::enc::encode_bwd<float>(static_cast<const float*>(g), static_cast<const float*>(x),
                                     amask, w, drop, static_cast<float*>(dx), out, B, S, E, H, L,
                                     scale, ws, accumulate, s);
}

// ---- the backward's blocks one by one, for the checks on the card ----

// Products of the backward, operands in the compute dtype. layout 1: C = A
// B^T, A (M, K), B (N, K), epilogue 0 out_f = C or 5 the ReLU gate (out_f =
// C where aux > 0, else 0; out_c its cd copy; aux (M, N) in cd); layout 2:
// C = A^T B over token chunks, A (K, M), B (K, N), epilogue 6: out_f (splits,
// M, N) the partial of each chunk of `chunk` tokens. One launch.
extern "C" int sasrec_product_bwd(int layout, int epi, const void* A, const void* B, int M,
                                  int N, int K, int splits, int chunk, const void* aux,
                                  float* out_f, void* out_c, int is_bf16, void* stream) {
  if (M < 1 || N < 32 || N % 32 || K < 1 || splits < 1 || chunk % 64 ||
      static_cast<long>(splits) * chunk < K || (layout == 1 && K % 32) ||
      (layout == 2 && M % 32))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto* a, auto* b, auto* ax, auto* oc) -> int {
    using T = std::remove_const_t<std::remove_pointer_t<decltype(a)>>;
    using namespace ctr;
    if (layout == 1 && epi == 0)
      return mma::launch_product<T, false, false>(a, b, M, N, K, 1, K, enc::EpiStore{out_f, N},
                                                  s);
    if (layout == 1 && epi == 5)
      return mma::launch_product<T, false, false>(a, b, M, N, K, 1, K,
                                                  enc::EpiGate<T>{ax, out_f, oc, N}, s);
    if (layout == 2 && epi == 6)
      return mma::launch_product<T, true, true>(
          a, b, M, N, K, splits, chunk,
          enc::EpiPartial{out_f, N, static_cast<size_t>(M) * N}, s);
    return static_cast<int>(cudaErrorInvalidValue);
  };
  if (is_bf16) {
    using T = __nv_bfloat16;
    return run(static_cast<const T*>(A), static_cast<const T*>(B), static_cast<const T*>(aux),
               static_cast<T*>(out_c));
  }
  return run(static_cast<const float*>(A), static_cast<const float*>(B),
             static_cast<const float*>(aux), static_cast<float*>(out_c));
}

// out = dh + the LayerNorm backward of dn over the first E of ld columns of
// (N, ld) fp32 (the rest written 0); out in cd when out_cd, else fp32 (may
// be dh). One launch.
extern "C" int sasrec_layer_norm_bwd(const float* dn, const float* xhat, const float* rstd,
                                     const float* scale, const float* dh, void* out, int N,
                                     int ld, int E, int out_cd, int is_bf16, void* stream) {
  if (N < 1 || E < 1 || ld < E) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_cd && is_bf16)
    return ctr::enc::launch_ln_bwd(dn, xhat, rstd, scale, dh, static_cast<__nv_bfloat16*>(out),
                                   N, ld, E, s);
  return ctr::enc::launch_ln_bwd(dn, xhat, rstd, scale, dh, static_cast<float*>(out), N, ld, E,
                                 s);
}

// The staged backward (attn_staged_fits(S, D)): dqkv (B*S, 3E) fp32 and its cd
// copy from qkv (B*S, 3E) fp32, the softmax P (B, H, S, S) and dao (B*S, E)
// fp32. One launch.
extern "C" int sasrec_attention_bwd(const float* qkv, const float* P, const float* dao,
                                    float* dqkv, void* dqkv_c, int B, int S, int E, int H, int D,
                                    float scale, int is_bf16, void* stream) {
  if (!ctr::enc::attention_block_ok(B, S, E, H, D) || !ctr::enc::attn_staged_fits(S, D))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return ctr::enc::launch_attn_bwd(qkv, P, dao, dqkv, static_cast<__nv_bfloat16*>(dqkv_c), B,
                                     S, E, H, D, scale, s);
  return ctr::enc::launch_attn_bwd(qkv, P, dao, dqkv, static_cast<float*>(dqkv_c), B, S, E, H, D,
                                   scale, s);
}

// The streamed backward, any S and D: dqkv (B*S, 3E) fp32 and its cd copy from qkv
// (B*S, 3E) fp32, amask (B, S), the forward's o32 (B*S, E) and stats (B, H,
// S) float2, and dao (B*S, E) fp32. One launch.
extern "C" int sasrec_attention_bwd_streamed(const float* qkv, const float* amask,
                                             const float* o32, const float* stats,
                                             const float* dao, float* dqkv, void* dqkv_c, int B,
                                             int S, int E, int H, int D, float scale, int is_bf16,
                                             void* stream) {
  if (!ctr::enc::attention_block_ok(B, S, E, H, D))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* st = reinterpret_cast<const float2*>(stats);
  if (is_bf16)
    return ctr::enc::launch_attn_bwd_streamed(qkv, amask, o32, st, dao, dqkv,
                                              static_cast<__nv_bfloat16*>(dqkv_c), B, S, E, H, D,
                                              scale, s);
  return ctr::enc::launch_attn_bwd_streamed(qkv, amask, o32, st, dao, dqkv,
                                            static_cast<float*>(dqkv_c), B, S, E, H, D, scale, s);
}

// Column sums of G (N, ncols) fp32 over Z chunks of `chunk` rows into part
// (Z, ncols): mode 0 sum G; 1 sum G X into part and sum G into part2; 2 the
// dropout gate of site (layer, branch): v = drop(G), gated = cd(v), sum v.
// One launch.
extern "C" int sasrec_column_sums(int mode, const float* G, const float* X, void* gated,
                                  const int64_t* seed, float rate, float inv_keep,
                                  unsigned token0, int layer, int branch, int N, int ncols, int Z,
                                  int chunk, float* part, float* part2, int is_bf16,
                                  void* stream) {
  if (N < 1 || ncols < 32 || ncols % 32 || Z < 1 || chunk < 1 ||
      static_cast<long>(Z) * chunk < N || !ctr::enc::dropout_ok(seed, rate))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dropout drop{seed, rate, inv_keep, token0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using namespace ctr::enc;
  auto run = [&](auto* gt) -> int {
    using T = std::remove_pointer_t<decltype(gt)>;
    const Split sp{Z, chunk};
    if (mode == kSum)
      return launch_column_sums<T, kSum>(G, X, gt, drop, layer, branch, N, ncols, sp, part, part2,
                                         ncols, s);
    if (mode == kLnSums)
      return launch_column_sums<T, kLnSums>(G, X, gt, drop, layer, branch, N, ncols, sp, part,
                                            part2, ncols, s);
    if (mode == kGate)
      return launch_column_sums<T, kGate>(G, X, gt, drop, layer, branch, N, ncols, sp, part,
                                          part2, ncols, s);
    return static_cast<int>(cudaErrorInvalidValue);
  };
  if (is_bf16) return run(static_cast<__nv_bfloat16*>(gated));
  return run(static_cast<float*>(gated));
}

// out[j] = sum over z = 0..Z-1, in that order, of part[z n + j]. One launch.
extern "C" int sasrec_reduce_partials(const float* part, int Z, int n, float* out, void* stream) {
  if (Z < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  ctr::enc::GradLayout lay{};  // one gradient of n floats in Z partials
  lay.size[0] = lay.out_total = static_cast<size_t>(n);
  lay.split[0] = ctr::enc::Split{Z, 0};
  return ctr::enc::launch_reduce(part, lay, out, static_cast<cudaStream_t>(stream));
}
