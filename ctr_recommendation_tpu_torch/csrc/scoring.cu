// Fused batched scoring for Hopper (sm_90a): interaction + folded tower.
//
// Replaces the TPU kernel ctr_recommendation_tpu/ops/pallas/scoring.py
// ::_kernel (:36), both its "all" and "each" bodies:
//
//   S, V as in interaction.cu, concat c = [S | pairs] in the tower dtype cd
//   h1 = cd(relu(c W1 + b1)); h2 = cd(relu(h1 W2 + b2))
//   prob = sigmoid(h2 w3 + b3)          fp32 accumulation, fp32 biases
//
// Bound on an H100: operations. At B=8192 the tower is 26 GFLOP against
// ~15 MB moved. The TPU kernel keeps a (TB, 2688) concat scratch and all of
// W1 in 16 MB of VMEM; a Hopper block has 227 KB of shared memory, so this
// design never materialises the concat. It streams it in E-wide K-chunks:
// each chunk (one field S_f or one pair product) is built in shared memory
// (transposed, so a thread reads its rows as one broadcast vector) and at
// once multiplied into the h1 accumulator, which stays in registers, against
// W1's matching rows, staged through shared memory KT rows at a time from
// L2. h1, h2 and the logit follow in the same block. The products are fp32
// FMA on the CUDA cores; tensor cores (wgmma, TMA) are later work.
//
// A block owns TB rows (32 for bf16, 16 for fp32, so S, V and the W1 stage
// fit) and 256 threads; each thread holds an (RT x 8) tile of h1 and of h2.
// The tower is compiled for hidden widths (512, 256), the model's
// (config/schema.py hidden_units). Rows past B are zero-filled and never
// stored.

#include "common.cuh"

namespace ctr {

constexpr int KT = 32;  // W1 / W2 rows staged per step

template <typename T, bool EACH, int TB, int H1, int H2>
__global__ void __launch_bounds__(kThreads, 1)
fused_score_kernel(const T* __restrict__ x, const float* __restrict__ sw1,
                   const float* __restrict__ sb1, const float* __restrict__ sw2,
                   const float* __restrict__ sb2, const T* __restrict__ wbi,
                   const T* __restrict__ tw1, const float* __restrict__ tb1,
                   const T* __restrict__ tw2, const float* __restrict__ tb2,
                   const T* __restrict__ tw3, const float* __restrict__ tb3,
                   float* __restrict__ out, int B, int F, int E, int R, size_t a_bytes,
                   int wbuf_floats) {
  constexpr int NG1 = H1 / 8, RT1 = TB * NG1 / kThreads;
  constexpr int NG2 = H2 / 8, RT2 = TB * NG2 / kThreads;
  static_assert(kThreads % NG1 == 0 && RT1 >= 4 && RT1 % 4 == 0, "tower layer 1 tiling");
  static_assert(kThreads % NG2 == 0 && RT2 >= 1, "tower layer 2 tiling");

  extern __shared__ __align__(16) unsigned char smem[];
  const int NV = F - 1;
  constexpr int LDC = TB + 4;  // padded chunk stride: keeps float4 rows, spreads banks
  constexpr int LDH = TB + 1;  // padded h1^T stride
  // region A: S (TB, F, E) and V (TB, F-1, E) in T; after layer 1, h1^T (H1, LDH)
  T* S_s = reinterpret_cast<T*>(smem);
  T* V_s = S_s + static_cast<size_t>(TB) * F * E;
  float* h1T = reinterpret_cast<float*>(smem);
  // wbuf: the bilinear W, then W1 / W2 stages, then h2 (TB, H2)
  float* wbuf = reinterpret_cast<float*>(smem + a_bytes);
  float* cT = wbuf + wbuf_floats;  // the current concat chunk, transposed (E, LDC)
  float* z_s = cT + static_cast<size_t>(E) * LDC;
  float* a_s = z_s + TB * F;
  float* w_s = a_s + TB * R;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * TB;

  load_rows(S_s, x, row0, TB, B, F * E);
  __syncthreads();
  senet_gate<T>(S_s, z_s, a_s, w_s, sw1, sb1, sw2, sb2, TB, F, E, R);

  // bilinear projections into V_s: "all" stores V_1..V_{F-1}, "each" V_0..V_{F-2}
  const int e4n = E / 4;
  for (int q = 0; q < NV; ++q) {
    if (EACH || q == 0) {
      __syncthreads();
      load_block_f32(wbuf, wbi + (EACH ? static_cast<size_t>(q) * E * E : 0), E * E);
      __syncthreads();
    }
    for (int t = tid; t < (TB / 4) * e4n; t += kThreads) {
      const int r0 = (t / e4n) * 4, c0 = (t % e4n) * 4;
      float v[4][4];
      proj_tile<T>(S_s, wbuf, F, E, EACH ? q : q + 1, r0, c0, v);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          V_s[(static_cast<size_t>(r0 + i) * NV + q) * E + c0 + j] = from_f<T>(v[i][j]);
    }
  }

  // ---- layer 1: h1 = relu(c W1 + b1), c streamed chunk by chunk ----
  const int cg1 = tid % NG1, rg1 = tid / NG1;
  float acc[RT1][8];
#pragma unroll
  for (int i = 0; i < RT1; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nchunks = F + F * (F - 1) / 2;
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
      load_block_f32(wbuf, tw1 + (static_cast<size_t>(ch) * E + ks) * H1, KT * H1);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KT; ++kk) {
        const float* crow = cT + (ks + kk) * LDC + rg1 * RT1;
        float a[RT1];
#pragma unroll
        for (int i = 0; i < RT1; i += 4) {
          const float4 c4 = *reinterpret_cast<const float4*>(crow + i);
          a[i] = c4.x;
          a[i + 1] = c4.y;
          a[i + 2] = c4.z;
          a[i + 3] = c4.w;
        }
        const float4* wrow = reinterpret_cast<const float4*>(wbuf + kk * H1 + cg1 * 8);
        const float4 w0 = wrow[0], w1v = wrow[1];
        const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1v.x, w1v.y, w1v.z, w1v.w};
#pragma unroll
        for (int i = 0; i < RT1; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * w[j];
      }
    }
  }
  __syncthreads();  // S, V and the last stage are dead: region A becomes h1^T
#pragma unroll
  for (int i = 0; i < RT1; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = cg1 * 8 + j;
      h1T[c * LDH + rg1 * RT1 + i] = rnd<T>(fmaxf(acc[i][j] + tb1[c], 0.f));
    }

  // ---- layer 2: h2 = relu(h1 W2 + b2) ----
  const int cg2 = tid % NG2, rg2 = tid / NG2;
  float acc2[RT2][8];
#pragma unroll
  for (int i = 0; i < RT2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc2[i][j] = 0.f;
  for (int ks = 0; ks < H1; ks += KT) {
    __syncthreads();
    load_block_f32(wbuf, tw2 + static_cast<size_t>(ks) * H2, KT * H2);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KT; ++kk) {
      const float* hrow = h1T + (ks + kk) * LDH + rg2 * RT2;
      float a[RT2];
#pragma unroll
      for (int i = 0; i < RT2; ++i) a[i] = hrow[i];
      const float4* wrow = reinterpret_cast<const float4*>(wbuf + kk * H2 + cg2 * 8);
      const float4 w0 = wrow[0], w1v = wrow[1];
      const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1v.x, w1v.y, w1v.z, w1v.w};
#pragma unroll
      for (int i = 0; i < RT2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc2[i][j] += a[i] * w[j];
    }
  }
  __syncthreads();  // the last W2 stage is dead: wbuf becomes h2 (TB, H2)
  float* h2s = wbuf;
#pragma unroll
  for (int i = 0; i < RT2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = cg2 * 8 + j;
      h2s[(rg2 * RT2 + i) * H2 + c] = rnd<T>(fmaxf(acc2[i][j] + tb2[c], 0.f));
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

constexpr int kH1 = 512, kH2 = 256;

template <typename T, bool EACH, int TB>
static int launch(const void* x, const float* sw1, const float* sb1, const float* sw2,
                  const float* sb2, const void* wbi, const void* tw1, const float* tb1,
                  const void* tw2, const float* tb2, const void* tw3, const float* tb3,
                  float* out, int B, int F, int E, int R, cudaStream_t stream) {
  size_t a_bytes = align16(static_cast<size_t>(TB) * (2 * F - 1) * E * sizeof(T));
  const size_t h1_bytes = static_cast<size_t>(TB + 1) * kH1 * sizeof(float);
  if (h1_bytes > a_bytes) a_bytes = h1_bytes;
  size_t wbuf = static_cast<size_t>(E) * E;
  const size_t stages[3] = {static_cast<size_t>(KT) * kH1, static_cast<size_t>(KT) * kH2,
                            static_cast<size_t>(TB) * kH2};
  for (size_t s : stages) wbuf = s > wbuf ? s : wbuf;
  const size_t smem =
      a_bytes + sizeof(float) * (wbuf + static_cast<size_t>(E) * (TB + 4) + TB * (2 * F + R));
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = fused_score_kernel<T, EACH, TB, kH1, kH2>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<(B + TB - 1) / TB, kThreads, smem, stream>>>(
      static_cast<const T*>(x), sw1, sb1, sw2, sb2, static_cast<const T*>(wbi),
      static_cast<const T*>(tw1), tb1, static_cast<const T*>(tw2), tb2,
      static_cast<const T*>(tw3), tb3, out, B, F, E, R, a_bytes, static_cast<int>(wbuf));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ctr

// x (B, F*E), wbi, tw1 (C, 512), tw2 (512, 256), tw3 (256, 1) in the tower
// dtype (bf16 when is_bf16, else fp32); SENet weights and all biases fp32;
// out (B,) fp32 probabilities. Requires E % 32 == 0, hidden (512, 256) and
// 16-byte aligned pointers. Returns a cudaError_t.
extern "C" int fused_score(const void* x, const float* sw1, const float* sb1,
                           const float* sw2, const float* sb2, const void* wbi,
                           const void* tw1, const float* tb1, const void* tw2,
                           const float* tb2, const void* tw3, const float* tb3, float* out,
                           int B, int F, int E, int R, int H1, int H2, int is_bf16, int each,
                           void* stream) {
  if (H1 != ctr::kH1 || H2 != ctr::kH2 || E % ctr::KT != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CTR_SCORE_ARGS \
  x, sw1, sb1, sw2, sb2, wbi, tw1, tb1, tw2, tb2, tw3, tb3, out, B, F, E, R, s
  if (is_bf16) {
    return each ? ctr::launch<__nv_bfloat16, true, 32>(CTR_SCORE_ARGS)
                : ctr::launch<__nv_bfloat16, false, 32>(CTR_SCORE_ARGS);
  }
  return each ? ctr::launch<float, true, 16>(CTR_SCORE_ARGS)
              : ctr::launch<float, false, 16>(CTR_SCORE_ARGS);
#undef CTR_SCORE_ARGS
}
