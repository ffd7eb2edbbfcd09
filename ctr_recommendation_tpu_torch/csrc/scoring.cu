// Fused batched scoring for Hopper (sm_90a): interaction + folded tower.
//
// Replaces the TPU kernel ctr_recommendation_tpu/ops/pallas/scoring.py
// ::_kernel (:36), both its "all" and "each" bodies:
//
//   S, V as in interaction.cu, concat c = [S | pairs] in the tower dtype cd
//   h1 = cd(relu(c W1 + b1)); h2 = cd(relu(h1 W2 + b2))
//   prob = sigmoid(h2 w3 + b3)          fp32 accumulation, fp32 biases
//
// Bound on an H100: operations. At B=8192, E=128 and the (512, 256) tower
// the tower is 26 GFLOP against ~15 MB moved (E=256 with (1024, 512): 99
// GFLOP). The TPU kernel keeps a (TB, 21E) concat scratch and all of W1 in
// VMEM; a Hopper block has 227 KB of shared memory, so this design never
// materialises the concat. It streams it in E-wide K-chunks: each chunk (one
// field S_f or one pair product) is rebuilt in shared memory from S and V
// (transposed, so a thread reads its rows as one broadcast vector) and at
// once multiplied into the h1 accumulator, which stays in registers, against
// W1's matching rows, staged through shared memory KT rows at a time from
// L2. h1, h2 and the logit follow in the same block. The products are fp32
// FMA on the CUDA cores; tensor cores (wgmma, TMA) are later work.
//
// Any two-layer tower. H1 and H2 are read at run time from the weights'
// shapes, as the TPU kernel reads them; the granularity is H1 % 32 == 0 and
// E % 32 == 0 (the K of layer 2 and of layer 1's chunks is staged KT = 32
// rows at a time, so the inner loops have a fixed trip count and fixed
// strides) and H2 % 8 == 0 (8-column register tiles, 16-byte weight rows).
// A block owns TB = 4 RT rows and 256 threads: 4 row groups of RT rows by
// 64 column groups of 8, so layer 1 runs in column passes of 512 h1 columns
// (one pass at H1=512, two at 1024; at 768 the second pass has 256 columns
// and half the threads idle); every pass rebuilds the concat chunks from S
// and V (cheap beside the products) and writes its columns of h1 (rounded
// to cd, so kept in cd) into h1^T. Layer 2 runs the same way over h2's
// columns, in passes of 512, or when H2 <= 256 of 256 columns by 8 row
// groups of RT/2 rows, so the (512, 256) tower keeps every thread busy.
// The bilinear W is staged in fp32 column blocks of nc columns (the whole W
// at E=128, 64 columns at E=256) as in interaction.cu.
// TB is the largest of 32, 16, 8 whose regions fit 227 KB: S and V (TB,
// 2F-1, E) in cd, h1^T (H1, TB+1) in cd, the weight stage, the chunk
// (E, TB+4) fp32; so TB=32 at E=128 with (512, 256) or (768, 384) in bf16,
// 16 at E=256 or with (1024, 512), and half that in fp32. Rows past B are
// zero-filled and never stored.

#include "common.cuh"

namespace ctr {

constexpr int KT = 32;         // W1 / W2 rows staged per step: E and H1 are multiples
constexpr int kGroups = 64;    // column groups of 8 in a pass; 256 / 64 = 4 row groups
constexpr int kPass = 8 * kGroups;

struct ScoreLayout {
  int tb, nc;
  size_t a, h1, wbuf, ct, small, total;
};

// Regions of one block: A = S, V (TB, 2F-1, E) in T, later h2 (TB, H2) fp32;
// h1^T (H1, TB+1) in T; wbuf (fp32: a W_bi column block, or a KT-row stage
// of W1 / W2 of row stride kPass); the chunk cT (E, TB+4) fp32; z, a, w
// (TB, F / R / F) fp32.
template <typename T>
inline ScoreLayout score_layout(int tb, int F, int E, int R, int H1, int H2) {
  ScoreLayout L;
  L.tb = tb;
  L.nc = weight_block_cols(E, static_cast<size_t>(KT) * kPass);
  const size_t sv = static_cast<size_t>(tb) * (2 * F - 1) * E * sizeof(T);
  const size_t h2 = static_cast<size_t>(tb) * H2 * sizeof(float);
  size_t wb = static_cast<size_t>(E) * L.nc;  // <= the KT-row stage of kPass columns
  wb = static_cast<size_t>(KT) * kPass > wb ? static_cast<size_t>(KT) * kPass : wb;
  size_t o = 0;
  L.a = o;
  o += align16(sv > h2 ? sv : h2);
  L.h1 = o;
  o += align16(static_cast<size_t>(H1) * (tb + 1) * sizeof(T));
  L.wbuf = o;
  o += align16(wb * sizeof(float));
  L.ct = o;
  o += align16(static_cast<size_t>(E) * (tb + 4) * sizeof(float));
  L.small = o;
  o += static_cast<size_t>(tb) * (2 * F + R) * sizeof(float);
  L.total = o;
  return L;
}

template <typename T>
inline ScoreLayout score_plan(int F, int E, int R, int H1, int H2) {
  for (int tb = 32; tb >= 8; tb /= 2) {
    const ScoreLayout L = score_layout<T>(tb, F, E, R, H1, H2);
    if (L.nc > 0 && L.total <= kMaxSmem) return L;
  }
  ScoreLayout none{};
  return none;
}

// N consecutive floats of shared memory (16-byte aligned for N >= 4, 8 for N = 2).
template <int N>
__device__ __forceinline__ void load_vec(float* dst, const float* src) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + i);
      dst[i] = v.x;
      dst[i + 1] = v.y;
      dst[i + 2] = v.z;
      dst[i + 3] = v.w;
    }
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(src);
    dst[0] = v.x;
    dst[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = src[i];
  }
}

// acc[i][j] += a[i] w[j] with w the 8 floats at w8 (16-byte aligned)
template <int RT>
__device__ __forceinline__ void fma_rows(float (&acc)[RT][8], const float (&a)[RT],
                                         const float* w8) {
  const float4 w0 = reinterpret_cast<const float4*>(w8)[0];
  const float4 w1 = reinterpret_cast<const float4*>(w8)[1];
  const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * w[j];
}

// Layer 2 in column passes of 8 NG columns: NG column groups by 256 / NG
// row groups of RT2 rows. h2 = cd(relu(h1 W2 + b2)) into h2s (TB, H2) fp32.
template <typename T, int RT2, int NG>
__device__ __forceinline__ void tower_layer2(const T* h1T, int ldh, const T* __restrict__ tw2,
                                             const float* __restrict__ tb2, float* wbuf,
                                             float* h2s, int H1, int H2) {
  const int cg = threadIdx.x % NG, rg = threadIdx.x / NG;
  for (int c0 = 0; c0 < H2; c0 += 8 * NG) {
    const int pw = H2 - c0 < 8 * NG ? H2 - c0 : 8 * NG;
    const int col = c0 + cg * 8;
    const bool act = col < H2;
    float acc[RT2][8];
#pragma unroll
    for (int i = 0; i < RT2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int ks = 0; ks < H1; ks += KT) {
      __syncthreads();  // every reader of the previous stage is done
      load_cols_f32(wbuf, 8 * NG, tw2 + static_cast<size_t>(ks) * H2, KT, H2, c0, pw);
      __syncthreads();
      if (act) {
#pragma unroll 4
        for (int kk = 0; kk < KT; ++kk) {
          const T* hrow = h1T + static_cast<size_t>(ks + kk) * ldh + rg * RT2;
          float a[RT2];
#pragma unroll
          for (int i = 0; i < RT2; ++i) a[i] = to_f(hrow[i]);
          fma_rows<RT2>(acc, a, wbuf + kk * (8 * NG) + cg * 8);
        }
      }
    }
    if (act) {
#pragma unroll
      for (int i = 0; i < RT2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = col + j;
          h2s[(rg * RT2 + i) * H2 + c] = rnd<T>(fmaxf(acc[i][j] + tb2[c], 0.f));
        }
    }
  }
}

template <typename T, bool EACH, int RT>
__global__ void __launch_bounds__(kThreads, 1)
fused_score_kernel(const T* __restrict__ x, const float* __restrict__ sw1,
                   const float* __restrict__ sb1, const float* __restrict__ sw2,
                   const float* __restrict__ sb2, const T* __restrict__ wbi,
                   const T* __restrict__ tw1, const float* __restrict__ tb1,
                   const T* __restrict__ tw2, const float* __restrict__ tb2,
                   const T* __restrict__ tw3, const float* __restrict__ tb3,
                   float* __restrict__ out, int B, int F, int E, int R, int H1, int H2,
                   ScoreLayout L) {
  constexpr int TB = 4 * RT;   // kThreads / kGroups row groups of RT rows
  constexpr int LDC = TB + 4;  // padded chunk stride: keeps float4 rows, spreads banks
  constexpr int LDH = TB + 1;  // padded h1^T stride
  static_assert(kThreads / kGroups == 4, "tower tiling");

  extern __shared__ __align__(16) unsigned char smem[];
  const int NV = F - 1;
  T* S_s = reinterpret_cast<T*>(smem + L.a);
  T* V_s = S_s + static_cast<size_t>(TB) * F * E;
  float* h2s = reinterpret_cast<float*>(smem + L.a);  // after layer 1
  T* h1T = reinterpret_cast<T*>(smem + L.h1);
  float* wbuf = reinterpret_cast<float*>(smem + L.wbuf);
  float* cT = reinterpret_cast<float*>(smem + L.ct);  // the current chunk, (E, LDC)
  float* z_s = reinterpret_cast<float*>(smem + L.small);
  float* a_s = z_s + TB * F;
  float* w_s = a_s + TB * R;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * TB;

  load_rows(S_s, x, row0, TB, B, F * E);
  __syncthreads();
  senet_gate<T>(S_s, z_s, a_s, w_s, sw1, sb1, sw2, sb2, TB, F, E, R);

  // bilinear projections into V_s: "all" stores V_1..V_{F-1}, "each"
  // V_0..V_{F-2}; W in column blocks of nc
  const int nc = L.nc, n4 = nc / 4;
  for (int cb = 0; cb < E; cb += nc) {
    for (int q = 0; q < NV; ++q) {
      if (EACH || q == 0) {
        __syncthreads();
        const T* wq = wbi + (EACH ? static_cast<size_t>(q) * E * E : 0);
        load_cols_f32(wbuf, nc, wq, E, E, cb, nc);
        __syncthreads();
      }
      for (int t = tid; t < (TB / 4) * n4; t += kThreads) {
        const int r0 = (t / n4) * 4, cl = (t % n4) * 4;
        float v[4][4];
        proj_tile<T>(S_s, wbuf + cl, nc, F, E, EACH ? q : q + 1, r0, v);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            V_s[(static_cast<size_t>(r0 + i) * NV + q) * E + cb + cl + j] = from_f<T>(v[i][j]);
      }
    }
  }

  // ---- layer 1: h1 = relu(c W1 + b1), c streamed chunk by chunk, in passes
  // of kPass columns ----
  const int cg = tid % kGroups, rg = tid / kGroups;
  const int nchunks = F + F * (F - 1) / 2;
  for (int c0 = 0; c0 < H1; c0 += kPass) {
    const int pw = H1 - c0 < kPass ? H1 - c0 : kPass;
    const int col = c0 + cg * 8;
    const bool act = col < H1;
    float acc[RT][8];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int ch = 0; ch < nchunks; ++ch) {
      int pi = 0, pj = 0;  // the pair (pi, pj) of chunk ch >= F, in triu order
      if (ch >= F) {
        int k = ch - F;
        while (k >= F - 1 - pi) {
          k -= F - 1 - pi;
          ++pi;
        }
        pj = pi + 1 + k;
      }
      __syncthreads();  // every reader of the previous chunk and W1 stage is done
      for (int idx = tid; idx < TB * E; idx += kThreads) {
        const int r = idx / E, k = idx % E;
        const size_t srow = static_cast<size_t>(r) * F;
        float val;
        if (ch < F) {
          val = to_f(S_s[(srow + ch) * E + k]);
        } else if (!EACH) {
          val = rnd<T>(to_f(S_s[(srow + pi) * E + k]) *
                       to_f(V_s[(static_cast<size_t>(r) * NV + pj - 1) * E + k]));
        } else {
          val = rnd<T>(to_f(V_s[(static_cast<size_t>(r) * NV + pi) * E + k]) *
                       to_f(S_s[(srow + pj) * E + k]));
        }
        cT[k * LDC + r] = val;
      }
      for (int ks = 0; ks < E; ks += KT) {
        if (ks > 0) __syncthreads();
        load_cols_f32(wbuf, kPass, tw1 + (static_cast<size_t>(ch) * E + ks) * H1, KT, H1, c0,
                      pw);
        __syncthreads();
        if (act) {
#pragma unroll 4
          for (int kk = 0; kk < KT; ++kk) {
            float a[RT];
            load_vec<RT>(a, cT + (ks + kk) * LDC + rg * RT);
            fma_rows<RT>(acc, a, wbuf + kk * kPass + cg * 8);
          }
        }
      }
    }
    if (act) {  // this pass's columns of h1, rounded to cd
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = col + j;
          h1T[c * LDH + rg * RT + i] = from_f<T>(fmaxf(acc[i][j] + tb1[c], 0.f));
        }
    }
  }
  __syncthreads();  // S and V are dead: region A becomes h2 (TB, H2)

  // ---- layer 2: h2 = relu(h1 W2 + b2) ----
  if (H2 <= kPass / 2) {
    tower_layer2<T, RT / 2 ? RT / 2 : 1, kGroups / 2>(h1T, LDH, tw2, tb2, wbuf, h2s, H1, H2);
  } else {
    tower_layer2<T, RT, kGroups>(h1T, LDH, tw2, tb2, wbuf, h2s, H1, H2);
  }
  __syncthreads();

  // ---- head: prob = sigmoid(h2 w3 + b3), one warp per row ----
  const int lane = tid & 31, warp = tid >> 5;
  for (int r = warp; r < TB; r += kThreads / 32) {
    float s = 0.f;
    for (int c = lane; c < H2; c += 32) s += h2s[r * H2 + c] * to_f(tw3[c]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0 && row0 + r < B) out[row0 + r] = 1.f / (1.f + expf(-(s + tb3[0])));
  }
}

template <typename T, bool EACH, int RT>
static int launch_rt(const void* x, const float* sw1, const float* sb1, const float* sw2,
                     const float* sb2, const void* wbi, const void* tw1, const float* tb1,
                     const void* tw2, const float* tb2, const void* tw3, const float* tb3,
                     float* out, int B, int F, int E, int R, int H1, int H2,
                     const ScoreLayout& L, cudaStream_t stream) {
  auto kern = fused_score_kernel<T, EACH, RT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<(B + L.tb - 1) / L.tb, kThreads, L.total, stream>>>(
      static_cast<const T*>(x), sw1, sb1, sw2, sb2, static_cast<const T*>(wbi),
      static_cast<const T*>(tw1), tb1, static_cast<const T*>(tw2), tb2,
      static_cast<const T*>(tw3), tb3, out, B, F, E, R, H1, H2, L);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool EACH>
static int launch(const void* x, const float* sw1, const float* sb1, const float* sw2,
                  const float* sb2, const void* wbi, const void* tw1, const float* tb1,
                  const void* tw2, const float* tb2, const void* tw3, const float* tb3,
                  float* out, int B, int F, int E, int R, int H1, int H2, cudaStream_t stream) {
  const ScoreLayout L = score_plan<T>(F, E, R, H1, H2);
#define CTR_SCORE_ARGS \
  x, sw1, sb1, sw2, sb2, wbi, tw1, tb1, tw2, tb2, tw3, tb3, out, B, F, E, R, H1, H2, L, stream
  switch (L.tb) {
    case 32: return launch_rt<T, EACH, 8>(CTR_SCORE_ARGS);
    case 16: return launch_rt<T, EACH, 4>(CTR_SCORE_ARGS);
    case 8: return launch_rt<T, EACH, 2>(CTR_SCORE_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CTR_SCORE_ARGS
}

}  // namespace ctr

// Rows per block for these sizes (0: no row tile fits a block).
extern "C" int fused_score_tile_rows(int F, int E, int R, int H1, int H2, int is_bf16) {
  return is_bf16 ? ctr::score_plan<__nv_bfloat16>(F, E, R, H1, H2).tb
                 : ctr::score_plan<float>(F, E, R, H1, H2).tb;
}

// x (B, F*E), wbi, tw1 (C, H1), tw2 (H1, H2), tw3 (H2, 1) in the tower dtype
// (bf16 when is_bf16, else fp32); SENet weights and all biases fp32; out (B,)
// fp32 probabilities. Requires F >= 2, E % 32 == 0, H1 % 32 == 0, H2 % 8 ==
// 0, a row tile that fits a block (fused_score_tile_rows) and 16-byte
// aligned pointers. Returns a cudaError_t.
extern "C" int fused_score(const void* x, const float* sw1, const float* sb1,
                           const float* sw2, const float* sb2, const void* wbi,
                           const void* tw1, const float* tb1, const void* tw2,
                           const float* tb2, const void* tw3, const float* tb3, float* out,
                           int B, int F, int E, int R, int H1, int H2, int is_bf16, int each,
                           void* stream) {
  if (F < 2 || E % ctr::KT || H1 % ctr::KT || H2 % 8 || H1 < 1 || H2 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CTR_SCORE_ARGS \
  x, sw1, sb1, sw2, sb2, wbi, tw1, tb1, tw2, tb2, tw3, tb3, out, B, F, E, R, H1, H2, s
  if (is_bf16) {
    return each ? ctr::launch<__nv_bfloat16, true>(CTR_SCORE_ARGS)
                : ctr::launch<__nv_bfloat16, false>(CTR_SCORE_ARGS);
  }
  return each ? ctr::launch<float, true>(CTR_SCORE_ARGS)
              : ctr::launch<float, false>(CTR_SCORE_ARGS);
#undef CTR_SCORE_ARGS
}
