// The fused SENet + bilinear + concat forward (see interaction.cu), as a
// kernel templated on its output type: interaction.cu instantiates the fp32
// output of the TPU kernel, scoring.cu the concat in the compute dtype, the
// A operand of its tower's first product. The values are the same: every S
// element and every pair product is rounded to the compute dtype T before it
// is stored, so storing it as T loses nothing.
#pragma once

#include "common.cuh"

namespace ctr {

struct FwdPlan {
  int tb, nc;
  size_t s_bytes, smem;
};

template <typename T>
inline FwdPlan fwd_plan(int F, int E, int R) {
  FwdPlan best{0, 0, 0, 0};
  for (int tb = 32; tb >= 4; tb /= 2) {
    const size_t s_bytes = align16(static_cast<size_t>(tb) * F * E * sizeof(T));
    for (int nc = E; nc >= 8; nc -= 8) {
      if (E % nc) continue;
      const size_t smem =
          s_bytes + sizeof(float) * (static_cast<size_t>(E) * nc + tb * (2 * F + R));
      if (smem > kMaxSmem) continue;
      if (tb * nc > best.tb * best.nc) best = FwdPlan{tb, nc, s_bytes, smem};
      break;  // the widest block that fits this tb
    }
  }
  return best;
}

// Four neighbouring values into p: 16 bytes of fp32 or 8 of bf16 (the
// values already representable in bf16, so the rounding is exact).
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                                            *reinterpret_cast<const unsigned*>(&hi));
}

template <typename T, bool EACH, typename OutT>
__global__ void __launch_bounds__(kThreads)
interaction_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w1,
                       const float* __restrict__ b1, const float* __restrict__ w2,
                       const float* __restrict__ b2, const T* __restrict__ wbi,
                       OutT* __restrict__ out, int B, int F, int E, int R, int TB, int nc,
                       size_t s_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* S_s = reinterpret_cast<T*>(smem);                    // (TB, F, E)
  float* W_s = reinterpret_cast<float*>(smem + s_bytes);  // (E, nc): a column block of W
  float* z_s = W_s + static_cast<size_t>(E) * nc;         // (TB, F)
  float* a_s = z_s + TB * F;                              // (TB, R)
  float* w_s = a_s + TB * R;                              // (TB, F)

  const int row0 = blockIdx.x * TB;
  const int P = F * (F - 1) / 2;
  const size_t out_stride = static_cast<size_t>(F + P) * E;

  load_rows(S_s, x, row0, TB, B, F * E);
  __syncthreads();
  senet_gate<T>(S_s, z_s, a_s, w_s, w1, b1, w2, b2, TB, F, E, R);

  // the S columns of the output
  const int fe = F * E;
  for (int i = threadIdx.x; i < TB * fe / 4; i += blockDim.x) {
    const int e4 = i * 4;
    const int r = e4 / fe, col = e4 % fe;
    if (row0 + r < B) {
      store4(out + static_cast<size_t>(row0 + r) * out_stride + col, to_f(S_s[e4]),
             to_f(S_s[e4 + 1]), to_f(S_s[e4 + 2]), to_f(S_s[e4 + 3]));
    }
  }

  const int n4 = nc / 4;
  const int tiles = (TB / 4) * n4;
  for (int cb = 0; cb < E; cb += nc) {
    for (int q = 0; q < F - 1; ++q) {
      const int p = EACH ? q : q + 1;  // the projected field ("all" never needs V_0)
      if (EACH || q == 0) {
        __syncthreads();  // every reader of the previous block is done
        const T* wq = wbi + (EACH ? static_cast<size_t>(q) * E * E : 0);
        load_cols_f32(W_s, nc, wq, E, E, cb, nc);
        __syncthreads();
      }
      for (int t = threadIdx.x; t < tiles; t += blockDim.x) {
        const int r0 = (t / n4) * 4, cl = (t % n4) * 4, c0 = cb + cl;
        float v[4][4];
        proj_tile<T>(S_s, W_s + cl, nc, F, E, p, r0, v);
        // "all": pairs (o, p) for o < p use S_o * V_p; "each": pairs (p, o)
        // for o > p use V_p * S_o
        const int lo = EACH ? p + 1 : 0;
        const int hi = EACH ? F : p;
        for (int o = lo; o < hi; ++o) {
          const int i = EACH ? p : o;
          const int j = EACH ? o : p;
          const int k = i * (2 * F - i - 1) / 2 + (j - i - 1);
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            const int r = r0 + rr;
            if (row0 + r >= B) continue;
            const T* srow = S_s + (static_cast<size_t>(r) * F + o) * E + c0;
            store4(out + static_cast<size_t>(row0 + r) * out_stride +
                       static_cast<size_t>(F + k) * E + c0,
                   rnd<T>(to_f(srow[0]) * v[rr][0]), rnd<T>(to_f(srow[1]) * v[rr][1]),
                   rnd<T>(to_f(srow[2]) * v[rr][2]), rnd<T>(to_f(srow[3]) * v[rr][3]));
          }
        }
      }
    }
  }
}

// One launch of the forward into out (B, (F + F(F-1)/2) E) of OutT; returns
// a cudaError_t (cudaErrorInvalidValue outside the envelope).
template <typename T, bool EACH, typename OutT>
int launch_interaction_fwd(const void* x, const float* w1, const float* b1, const float* w2,
                           const float* b2, const void* wbi, OutT* out, int B, int F, int E,
                           int R, cudaStream_t stream) {
  const FwdPlan plan = fwd_plan<T>(F, E, R);
  if (plan.tb < 4 || E % 8 || F < 2) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = interaction_fwd_kernel<T, EACH, OutT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(plan.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<(B + plan.tb - 1) / plan.tb, kThreads, plan.smem, stream>>>(
      static_cast<const T*>(x), w1, b1, w2, b2, static_cast<const T*>(wbi), out, B, F, E, R,
      plan.tb, plan.nc, plan.s_bytes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ctr
