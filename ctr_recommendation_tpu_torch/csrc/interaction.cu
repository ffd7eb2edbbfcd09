// Fused SENet + bilinear + concat forward for Hopper (sm_90a).
//
// Replaces the TPU kernel ctr_recommendation_tpu/ops/pallas/interaction.py
// ::_kernel_all (:56) and ::_kernel_each (:94), one pallas_call with two
// bodies; here one sequence of building blocks templated on the bilinear
// type.
//
//   z = mean_E(x) (fp32); w = sigmoid(relu(z W1 + b1) W2 + b2) (fp32)
//   S = x * cd(w) in the compute dtype cd
//   V_p = cd(S_p W)   (or S_p W_p for "each"), fp32 accumulation
//   out = fp32 [S_0 .. S_{F-1} | S_i * V_j ("all") or V_i * S_j ("each")
//                                over the pairs i < j in triu order]
//
// Bound on an H100: bytes. At B=8192, F=6, E=128, bf16 in, it reads 12.6 MB
// and writes 88 MB of fp32 (30 us at 3.35 TB/s), against ~1.3 GFLOP of
// projection (E=256: 25 MB and 176 MB against ~5.4 GFLOP), far below the
// tensor cores' line. The design (interaction.cuh) is three launches on one
// stream: the gate writes w and sc = cd(x_p cd(w_p)) field-major; V =
// cd(sc W) runs on tile_mma.cuh's product (bf16 mma.sync, fp32 CUDA-core
// FMA with fp64 accumulators, never TF32) and stores V in cd; the pairs
// pass recomputes S from x and w and writes each output element once. The
// sequence moves ~155 MB at B=8192, E=128 (x twice, sc and V in cd each
// written and read, the output), ~46 us at 3.35 TB/s. The wrapper allocates
// one workspace for w, sc and V; the kernels allocate nothing. Rows past B
// are never read or stored, so any B works.
//
// Envelope: F >= 2, E % 8 == 0 (16-byte rows and staged pieces), any B.
// The pairs pass keeps a row's S in registers for F <= 8 and recomputes it
// from x beyond. The scoring call (scoring.cu) runs the same blocks with the
// concat stored in cd, the values of this output bit for bit.

#include "interaction.cuh"

namespace {
template <typename T>
const T* cd(const void* p) {
  return static_cast<const T*>(p);
}
template <typename T>
T* cd_mut(void* p) {
  return static_cast<T*>(p);
}
bool bad_dims(int B, int F, int E) { return B < 1 || !ctr::fwd_in_envelope(F, E); }
}  // namespace

// Each entry point below enqueues its launches on `stream`, requires 16-byte
// aligned pointers and F >= 2, E % 8 == 0, B >= 1, and returns a
// cudaError_t (cudaErrorInvalidValue outside the envelope). Tensors in the
// compute dtype (bf16 when is_bf16, else fp32) are void*; the rest fp32.
// Q = F - 1 projected fields.

// Block 1: x (B, F, E) -> w (B, F) fp32, sc = cd(x_p cd(w_p)) (Q, B, E) in cd.
extern "C" int ifwd_gate(const void* x, const float* w1, const float* b1, const float* w2,
                         const float* b2, float* w, void* sc, int B, int F, int E, int R,
                         int is_bf16, int each, void* stream) {
  if (bad_dims(B, F, E) || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    return ctr::launch_gate<T, true>(cd<T>(x), w1, b1, w2, b2, nullptr, nullptr, w, cd_mut<T>(sc),
                                     B, F, E, R, each, s);
  }
  return ctr::launch_gate<float, true>(cd<float>(x), w1, b1, w2, b2, nullptr, nullptr, w,
                                       cd_mut<float>(sc), B, F, E, R, each, s);
}

// Block 2: V (Q, B, E) = cd(sc W) in cd ("all": W (E, E); "each": W (Q, E, E)).
extern "C" int ifwd_project(const void* sc, const void* wbi, void* V, int B, int F, int E,
                            int is_bf16, int each, void* stream) {
  if (bad_dims(B, F, E)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    return ctr::launch_fwd_project<T>(cd<T>(sc), cd<T>(wbi), cd_mut<T>(V), B, F, E, each, s);
  }
  return ctr::launch_fwd_project<float>(cd<float>(sc), cd<float>(wbi), cd_mut<float>(V), B, F, E,
                                        each, s);
}

// Block 3: x (B, F, E), w (B, F), V (Q, B, E) -> out (B, (F + F(F-1)/2) E)
// fp32 (scoring.cu instantiates the same pass storing in cd).
extern "C" int ifwd_pairs(const void* x, const float* w, const void* V, float* out, int B, int F,
                          int E, int is_bf16, int each, void* stream) {
  if (bad_dims(B, F, E)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    return ctr::launch_fwd_pairs<T, float>(cd<T>(x), w, cd<T>(V), out, B, F, E, each, s);
  }
  return ctr::launch_fwd_pairs<float, float>(cd<float>(x), w, cd<float>(V), out, B, F, E, each, s);
}

// Bytes of workspace interaction_fwd needs at these sizes (0 outside the envelope).
extern "C" size_t interaction_fwd_workspace(int B, int F, int E, int is_bf16) {
  if (bad_dims(B, F, E)) return 0;
  return ctr::FwdWork(nullptr, B, F, E, is_bf16 ? 2 : 4).bytes;
}

// The whole forward, blocks 1-3 in order on one stream (3 launches). x (B,
// F*E) and wbi ((E, E) or (Q, E, E)) in cd; SENet weights fp32; out (B, (F +
// F(F-1)/2) * E) fp32; workspace holds interaction_fwd_workspace bytes for w
// (B, F) fp32 and sc, V (Q, B, E) in cd.
extern "C" int interaction_fwd(const void* x, const float* w1, const float* b1,
                               const float* w2, const float* b2, const void* wbi, float* out,
                               void* workspace, int B, int F, int E, int R, int is_bf16, int each,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    return ctr::launch_interaction_fwd<T, float>(cd<T>(x), w1, b1, w2, b2, cd<T>(wbi), out,
                                                 workspace, B, F, E, R, each, s);
  }
  return ctr::launch_interaction_fwd<float, float>(cd<float>(x), w1, b1, w2, b2, cd<float>(wbi),
                                                   out, workspace, B, F, E, R, each, s);
}
