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
//
// The kernel lives in interaction.cuh, templated on its output type: this
// file instantiates the fp32 output; scoring.cu stores the same values in
// the compute dtype, the concat its tower's first product reads.

#include "interaction.cuh"

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
#define CTR_FWD_ARGS x, w1, b1, w2, b2, wbi, out, B, F, E, R, s
  if (is_bf16) {
    return each ? ctr::launch_interaction_fwd<__nv_bfloat16, true>(CTR_FWD_ARGS)
                : ctr::launch_interaction_fwd<__nv_bfloat16, false>(CTR_FWD_ARGS);
  }
  return each ? ctr::launch_interaction_fwd<float, true>(CTR_FWD_ARGS)
              : ctr::launch_interaction_fwd<float, false>(CTR_FWD_ARGS);
#undef CTR_FWD_ARGS
}
