// Fused batched scoring for Hopper (sm_90a): interaction + folded tower.
//
// Replaces the TPU kernel ctr_recommendation_tpu/ops/pallas/scoring.py
// ::_kernel (:36), both its "all" and "each" bodies:
//
//   S, V, pairs as in interaction.cu; c = [S | pairs] in the tower dtype cd
//   h1 = cd(relu(c W1 + b1)); h2 = cd(relu(h1 W2 + b2))
//   prob = sigmoid(h2 w3 + b3)          fp32 accumulation, fp32 biases
//
// Bound on an H100: operations. At B=8192, E=128 and the (512, 256) tower
// the call is 26 GFLOP (26.3 us at 989 TFLOP/s bf16) against ~15 MB of
// input, weights and output; at E=256 with (1024, 512), 104 GFLOP. The TPU
// kernel keeps a (TB, 21E) concat and all of W1 in VMEM; a Hopper block has
// 227 KB of shared memory, and a kernel that rebuilds the concat per row
// tile re-reads W1 from L2 for every 16 or 32 rows. So the call is a
// sequence of four blocks whose products run on the tensor cores:
//
//   1. front: interaction.cu's three launches (interaction.cuh: the gate,
//      V = cd(sc W) on the tile product, the pairs) storing c (B, 21E) in
//      cd, the interaction forward's output bit for bit;
//   2. layer 1: the tile product of tile_mma.cuh, c (B, 21E) x W1 (21E, H1),
//      with the EpiRelu epilogue into h1 (B, H1) in cd;
//   3. layer 2: the same product, h1 x W2 (H1, H2), into h2 (B, H2) in cd;
//   4. head: sigmoid(h2 w3 + b3), one warp a row, a warp-shuffle sum.
//
// bf16 products are ldmatrix / mma.sync with fp32 accumulators on 128 x 128
// tiles (W1 read once per 128 rows, not per 16 or 32); fp32 products run
// the same tile loop on the CUDA cores with fp64 accumulation (never TF32).
// c, h1, h2 and the front's scratch (sc and V) cross device memory (~180
// MB at B=8192, E=128, x read twice: ~54 us at 3.35 TB/s, the sequence's
// own floor above the bound); the caller allocates them, the kernels allocate nothing. Rows
// past B are never read into a product's result or stored, so any B works.
//
// Envelope: F >= 2, E % 8 == 0, H1 % 8 == 0 and H2 % 8 == 0 (the products'
// K and N are multiples of 8: 16-byte rows, 16-byte staged pieces), any
// two-layer tower (H1 and H2 read from the weights' shapes, as the TPU kernel
// reads them). What is left: wgmma with TMA-staged, swizzled tiles for the
// products, and the front fused into layer 1's A staging so that c never
// reaches device memory.

#include "interaction.cuh"
#include "tile_mma.cuh"

namespace ctr {

constexpr int kHeadRows = kThreads / 32;  // rows a head block scores: one warp each

// prob[r] = sigmoid(sum_c h2[r, c] w3[c] + b3), fp32 sums, H2 even.
template <typename T>
__global__ void __launch_bounds__(kThreads)
score_head_kernel(const T* __restrict__ h2, const T* __restrict__ w3,
                  const float* __restrict__ b3, float* __restrict__ out, int B, int H2) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kHeadRows + (threadIdx.x >> 5);
  if (row >= B) return;  // the whole warp: row is the warp's
  const T* h = h2 + static_cast<size_t>(row) * H2;
  float s = 0.f;
  for (int c = 2 * lane; c < H2; c += 64) {
    const float2 hv = mma::load2(h + c), wv = mma::load2(w3 + c);
    s += hv.x * wv.x + hv.y * wv.y;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) out[row] = 1.f / (1.f + expf(-(s + b3[0])));
}

template <typename T>
int launch_front(const void* x, const float* sw1, const float* sb1, const float* sw2,
                 const float* sb2, const void* wbi, void* c, void* ws, int B, int F, int E, int R,
                 int each, cudaStream_t s) {
  return launch_interaction_fwd<T, T>(static_cast<const T*>(x), sw1, sb1, sw2, sb2,
                                      static_cast<const T*>(wbi), static_cast<T*>(c), ws, B, F, E,
                                      R, each, s);
}

template <typename T>
int launch_layer(const void* a, const void* w, const float* bias, void* out, int M, int N, int K,
                 cudaStream_t s) {
  return mma::launch_product<T, false, true>(static_cast<const T*>(a), static_cast<const T*>(w),
                                             M, N, K, 1, K,
                                             mma::EpiRelu<T>{static_cast<T*>(out), N, bias}, s);
}

template <typename T>
int launch_head(const void* h2, const void* w3, const float* b3, float* out, int B, int H2,
                cudaStream_t s) {
  score_head_kernel<T><<<(B + kHeadRows - 1) / kHeadRows, kThreads, 0, s>>>(
      static_cast<const T*>(h2), static_cast<const T*>(w3), b3, out, B, H2);
  return static_cast<int>(cudaGetLastError());
}

inline bool in_envelope(int F, int E, int H1, int H2) {
  return fwd_in_envelope(F, E) && H1 % 8 == 0 && H2 % 8 == 0 && H1 > 0 && H2 > 0;
}

}  // namespace ctr

#define CTR_BY_DTYPE(fn, ...) \
  (is_bf16 ? ctr::fn<__nv_bfloat16>(__VA_ARGS__) : ctr::fn<float>(__VA_ARGS__))

// Bytes of the front's workspace at these sizes (interaction_fwd's).
extern "C" size_t score_front_workspace(int B, int F, int E, int is_bf16) {
  if (B < 1 || !ctr::fwd_in_envelope(F, E)) return 0;
  return ctr::FwdWork(nullptr, B, F, E, is_bf16 ? 2 : 4).bytes;
}

// Block 1, the front (three launches): x (B, F*E), wbi in cd -> c (B, (F +
// F(F-1)/2) E) in cd; ws holds score_front_workspace bytes.
extern "C" int score_front(const void* x, const float* sw1, const float* sb1, const float* sw2,
                           const float* sb2, const void* wbi, void* c, void* ws, int B, int F,
                           int E, int R, int is_bf16, int each, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return CTR_BY_DTYPE(launch_front, x, sw1, sb1, sw2, sb2, wbi, c, ws, B, F, E, R, each, s);
}

// Blocks 2-3, one tower layer: out (M, N) = cd(relu(a (M, K) w (K, N) + bias)),
// a, w, out in cd, bias fp32; N % 8 == 0 and K % 8 == 0.
extern "C" int score_layer(const void* a, const void* w, const float* bias, void* out, int M,
                           int N, int K, int is_bf16, void* stream) {
  if (N % 8 || K % 8 || N < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return CTR_BY_DTYPE(launch_layer, a, w, bias, out, M, N, K, s);
}

// Block 4, the head: out (B,) fp32 = sigmoid(h2 (B, H2) w3 (H2,) + b3), h2 and
// w3 in cd; H2 % 8 == 0.
extern "C" int score_head(const void* h2, const void* w3, const float* b3, float* out, int B,
                          int H2, int is_bf16, void* stream) {
  if (H2 % 8 || H2 < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return CTR_BY_DTYPE(launch_head, h2, w3, b3, out, B, H2, s);
}

// The whole call, the four blocks in order on one stream (six launches).
// x (B, F*E), wbi, tw1 (C, H1), tw2 (H1, H2), tw3 (H2, 1) in the tower dtype
// (bf16 when is_bf16, else fp32); SENet weights and all biases fp32;
// scratch c (B, C), h1 (B, H1), h2 (B, H2) in the tower dtype and ws, the
// front's score_front_workspace bytes; out (B,) fp32 probabilities.
// Requires the envelope of the file's note and 16-byte aligned pointers.
// Returns the first cudaError_t of the launches.
extern "C" int fused_score(const void* x, const float* sw1, const float* sb1,
                           const float* sw2, const float* sb2, const void* wbi,
                           const void* tw1, const float* tb1, const void* tw2,
                           const float* tb2, const void* tw3, const float* tb3, void* c,
                           void* h1, void* h2, void* ws, float* out, int B, int F, int E, int R,
                           int H1, int H2, int is_bf16, int each, void* stream) {
  if (!ctr::in_envelope(F, E, H1, H2)) return static_cast<int>(cudaErrorInvalidValue);
  const int C = (F + F * (F - 1) / 2) * E;
  int rc = score_front(x, sw1, sb1, sw2, sb2, wbi, c, ws, B, F, E, R, is_bf16, each, stream);
  if (rc == 0) rc = score_layer(c, tw1, tb1, h1, B, H1, C, is_bf16, stream);
  if (rc == 0) rc = score_layer(h1, tw2, tb2, h2, B, H2, H1, is_bf16, stream);
  if (rc == 0) rc = score_head(h2, tw3, tb3, out, B, H2, is_bf16, stream);
  return rc;
}

#undef CTR_BY_DTYPE
