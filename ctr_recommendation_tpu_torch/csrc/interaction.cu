// Fused SENet + bilinear + concat forward for Hopper (sm_90a).
//
// Replaces the TPU kernel ctr_recommendation_tpu/ops/pallas/interaction.py
// ::_kernel_all (:56) and ::_kernel_each (:94), one pallas_call with two
// bodies; here one kernel templated on the bilinear type.
//
//   z = mean_E(x) (fp32); w = sigmoid(relu(z W1 + b1) W2 + b2) (fp32)
//   S = x * cd(w) in the compute dtype cd
//   V_p = cd(S_p W)   (or S_p W_p for "each"), fp32 accumulation
//   out = fp32 [S_0 .. S_{F-1} | S_i * V_j ("all") or V_i * S_j ("each")
//                                over the pairs i < j in triu order]
//
// Bound on an H100: bytes. At B=8192, F=6, E=128, bf16 in, it reads 12.6 MB
// and writes 88 MB of fp32, against ~1.3 GFLOP of projection (E=256: 25 MB
// and 176 MB against ~5.4 GFLOP). The design keeps x and S in shared memory
// and writes each output element once, as a 16-byte store from a thread
// whose neighbours write the neighbouring 16 bytes; V never leaves registers
// (each 4x4 tile of V_p writes every pair that uses it at once).
//
// The bilinear weight is staged in fp32 column blocks of nc columns: E x E
// in fp32 is 256 KB at E=256, more than a block's 227 KB, so the tile loop
// walks the column blocks (for "all" each block serves every projected
// field before the next is staged). A block owns TB rows and 256 threads;
// (TB, nc) is the pair that fits shared memory with the most 4x4 tiles a
// stage, larger TB first: at E=128 W stays whole (TB=32, nc=128) in both
// dtypes; at E=256 bf16 TB=32, nc=128; fp32 TB=16, nc=128. A column's sum
// runs over k in the same order for any nc, so the blocking changes no
// result. The ragged last tile is masked: rows past B are zero-filled on
// load and never stored.

#include "common.cuh"

namespace ctr {

struct FwdPlan {
  int tb, nc;
  size_t s_bytes, smem;
};

template <typename T>
static FwdPlan fwd_plan(int F, int E, int R) {
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

template <typename T, bool EACH>
__global__ void __launch_bounds__(kThreads)
interaction_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w1,
                       const float* __restrict__ b1, const float* __restrict__ w2,
                       const float* __restrict__ b2, const T* __restrict__ wbi,
                       float* __restrict__ out, int B, int F, int E, int R, int TB, int nc,
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
      const float4 o = make_float4(to_f(S_s[e4]), to_f(S_s[e4 + 1]), to_f(S_s[e4 + 2]),
                                   to_f(S_s[e4 + 3]));
      *reinterpret_cast<float4*>(out + static_cast<size_t>(row0 + r) * out_stride + col) = o;
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
            const float4 res = make_float4(
                rnd<T>(to_f(srow[0]) * v[rr][0]), rnd<T>(to_f(srow[1]) * v[rr][1]),
                rnd<T>(to_f(srow[2]) * v[rr][2]), rnd<T>(to_f(srow[3]) * v[rr][3]));
            *reinterpret_cast<float4*>(out + static_cast<size_t>(row0 + r) * out_stride +
                                       static_cast<size_t>(F + k) * E + c0) = res;
          }
        }
      }
    }
  }
}

template <typename T, bool EACH>
static int launch(const void* x, const float* w1, const float* b1, const float* w2,
                  const float* b2, const void* wbi, float* out, int B, int F, int E, int R,
                  cudaStream_t stream) {
  const FwdPlan plan = fwd_plan<T>(F, E, R);
  if (plan.tb < 4 || E % 8 || F < 2) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = interaction_fwd_kernel<T, EACH>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(plan.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<(B + plan.tb - 1) / plan.tb, kThreads, plan.smem, stream>>>(
      static_cast<const T*>(x), w1, b1, w2, b2, static_cast<const T*>(wbi), out, B, F, E, R,
      plan.tb, plan.nc, plan.s_bytes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ctr

// Rows per block for these sizes (0: no row tile fits a block).
extern "C" int interaction_fwd_tile_rows(int F, int E, int R, int is_bf16) {
  return is_bf16 ? ctr::fwd_plan<__nv_bfloat16>(F, E, R).tb : ctr::fwd_plan<float>(F, E, R).tb;
}

// x (B, F*E) and wbi ((E, E) or (F-1, E, E)) in the compute dtype (bf16 when
// is_bf16, else fp32); SENet weights fp32; out (B, (F + F(F-1)/2) * E) fp32.
// Requires F >= 2, E % 8 == 0, a row tile of at least 4 that fits a block
// (interaction_fwd_tile_rows) and 16-byte aligned pointers. Returns a cudaError_t.
extern "C" int interaction_fwd(const void* x, const float* w1, const float* b1,
                               const float* w2, const float* b2, const void* wbi, float* out,
                               int B, int F, int E, int R, int is_bf16, int each,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return each ? ctr::launch<__nv_bfloat16, true>(x, w1, b1, w2, b2, wbi, out, B, F, E, R, s)
                : ctr::launch<__nv_bfloat16, false>(x, w1, b1, w2, b2, wbi, out, B, F, E, R, s);
  }
  return each ? ctr::launch<float, true>(x, w1, b1, w2, b2, wbi, out, B, F, E, R, s)
              : ctr::launch<float, false>(x, w1, b1, w2, b2, wbi, out, B, F, E, R, s);
}
