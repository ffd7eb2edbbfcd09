// One hand-written tile product for Hopper (sm_90a), shared by the SASRec
// encoder's forward and backward (sasrec_encoder.cuh), the scoring tower's
// two hidden layers (scoring.cu), the interaction backward's three E x E
// products (interaction_bwd.cu) and the forward's projection
// (interaction.cuh, so also the scoring front):
//
//   C[m, n] = sum over k in a split of A(m, k) B(k, n),  then epi(m, n, z, C)
//
// Each operand is read in the layout it has in device memory: A as (M, K)
// row-major, or "k-major" (K, M) row-major, the transposed operand of a
// weight gradient A^T G; B as (K, N) row-major ("k-major"), or (N, K)
// row-major, the weight of a transposed product dY W^T. A block computes a
// 128 x 128 tile of C from BK-deep slices (64 in bf16, 16 in fp32) staged
// by cp.async into three buffers, two slices loading while one is consumed
// (108 KB and 56 KB of dynamic shared memory: two blocks an SM);
// rows and columns past M, N and the split's end are zero-filled, never
// read, so any M (B*S tokens with a ragged B) works; N and K are multiples
// of 8 elements. The epilogue takes single elements (fp32) or pairs of
// neighbouring columns (bf16), so its stores are 8 or 4 bytes wide.
//
// bf16: operands through ldmatrix (ldmatrix.trans where the stored layout
// is the transpose of the fragment's) into mma.sync.m16n8k16 with fp32
// accumulators; 8 warps in 2 x 4, each a 64 x 32 tile. fp32: the same tile
// loop on the CUDA cores, each thread 8 x 8 outputs strided by 16, fp64
// FMA into fp64 accumulators; never TF32, so the fp32 path keeps full fp32
// products.
//
// gridDim.z = groups x splits. A group g is one more product of the same
// shape on operands a_gs and b_gs elements further on (the per-field
// products of the interaction backward's "each"); a split s of a group
// sums k in [s chunk, min(K, (s + 1) chunk)), chunk a multiple of BK. The
// epilogue gets z = g splits + s and writes its own slice or partial; a
// fixed-order reduction elsewhere sums the partials (no atomics).
#pragma once

#include "common.cuh"

namespace ctr {
namespace mma {

constexpr int BM = 128, BN = 128;
constexpr int kThreads = 256;
constexpr int kStages = 3;  // slices in flight: one consumed, two loading

template <typename T> struct Cfg;
template <> struct Cfg<__nv_bfloat16> {
  static constexpr int BK = 64;  // 256 mma a warp a slice: the next slice's loads hide behind it
  static constexpr int PAD = 8;  // 16 bytes: ldmatrix rows land on distinct banks
};
template <> struct Cfg<float> {
  static constexpr int BK = 16;
  static constexpr int PAD = 4;
};

// Shape of one staged operand tile: OUTER (BM or BN) by BK, stored as in
// device memory: (BK, OUTER) when KMAJOR, else (OUTER, BK); ld is the row
// stride in elements.
template <typename T, bool KMAJOR, int OUTER>
struct Tile {
  static constexpr int BK = Cfg<T>::BK;
  static constexpr int ROWS = KMAJOR ? BK : OUTER;
  static constexpr int COLS = KMAJOR ? OUTER : BK;
  static constexpr int LD = COLS + Cfg<T>::PAD;
  static constexpr int ELEMS = ROWS * LD;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0: the 16 bytes are zero-filled, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + ROWS) and columns [col0, col0 + COLS) of the row-major
// matrix g (row stride ldg) into s (row stride TL::LD), 16 bytes a copy;
// pieces at or past (row_lim, col_lim) are zero-filled.
template <typename T, typename TL>
__device__ __forceinline__ void stage(T* s, const T* __restrict__ g, size_t ldg, int row0,
                                      int row_lim, int col0, int col_lim) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = TL::COLS / VEC;
  for (int i = threadIdx.x; i < TL::ROWS * PER_ROW; i += kThreads) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    const int gr = row0 + r, gc = col0 + c;
    const bool ok = gr < row_lim && gc < col_lim;
    cp_async16(s + r * TL::LD + c, ok ? g + static_cast<size_t>(gr) * ldg + gc : g, ok);
  }
}

__device__ __forceinline__ void ldsm_x4(unsigned r[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned r[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The accumulators of one thread and how its tile is consumed, per dtype.
template <typename T, bool A_KM, bool B_KM> struct Core;

// bf16: warp (wm, wn) = (warp / 4, warp % 4) owns rows wm*64 + [0, 64) and
// columns wn*32 + [0, 32): 4 x 4 fragments of 16 x 8. Accumulator e of
// fragment (i, j) is row 16 i + lane/4 + 8 (e/2), column 8 j + 2 (lane%4)
// + e%2 of the warp's tile (the mma.sync C layout).
template <bool A_KM, bool B_KM>
struct Core<__nv_bfloat16, A_KM, B_KM> {
  using T = __nv_bfloat16;
  using TA = Tile<T, A_KM, BM>;
  using TB = Tile<T, B_KM, BN>;
  float acc[4][4][4];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  __device__ __forceinline__ void step(const T* sa, const T* sb) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
    const int mat = lane >> 3, r8 = lane & 7;
#pragma unroll
    for (int ks = 0; ks < TA::BK; ks += 16) {
      unsigned a[4][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m0 = wm + i * 16;
        if (A_KM)  // stored (k, m): matrices (k0, m0) (k0, m8) (k8, m0) (k8, m8)
          ldsm_x4_trans(a[i], sa + (ks + r8 + (mat >> 1) * 8) * TA::LD + m0 + (mat & 1) * 8);
        else  // stored (m, k): matrices (m0, k0) (m8, k0) (m0, k8) (m8, k8)
          ldsm_x4(a[i], sa + (m0 + r8 + (mat & 1) * 8) * TA::LD + ks + (mat >> 1) * 8);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n0 = wn + j * 16;
        if (B_KM)  // stored (k, n): matrices (k0, n0) (k8, n0) (k0, n8) (k8, n8)
          ldsm_x4_trans(b[j], sb + (ks + r8 + (mat & 1) * 8) * TB::LD + n0 + (mat >> 1) * 8);
        else  // stored (n, k): matrices (n0, k0) (n0, k8) (n8, k0) (n8, k8)
          ldsm_x4(b[j], sb + (n0 + r8 + (mat >> 1) * 8) * TB::LD + ks + (mat & 1) * 8);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], a[i], b[j >> 1][(j & 1) * 2], b[j >> 1][(j & 1) * 2 + 1]);
    }
  }

  template <typename Epi>
  __device__ __forceinline__ void store(const Epi& epi, int m0, int n0, int M, int N, int z) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int rb = m0 + (warp >> 2) * 64 + (lane >> 2);
    const int cb = n0 + (warp & 3) * 32 + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // columns c, c + 1 of row r: one pair
          const int r = rb + i * 16 + h * 8, c = cb + j * 8;
          if (r < M && c < N) epi.pair(r, c, z, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
  }
};

// fp32: thread (tm, tn) = (tid / 16, tid % 16) owns rows tm + 16 i and
// columns tn + 16 j, i, j < 8; each k adds a[i] b[j], in k order, into an
// fp64 accumulator (a product of two fp32 values is exact there), so the
// stored sum is the correctly rounded fp32 of the exact one but in rare
// near-ties. The fp32 plain version accumulates in fp64 too, so a ReLU gate
// read from such a sum (z1 > 0) falls on the same side in both unless an
// operand already differs.
template <bool A_KM, bool B_KM>
struct Core<float, A_KM, B_KM> {
  using TA = Tile<float, A_KM, BM>;
  using TB = Tile<float, B_KM, BN>;
  double acc[8][8];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0;
  }

  __device__ __forceinline__ void step(const float* sa, const float* sb) {
    const int tm = threadIdx.x >> 4, tn = threadIdx.x & 15;
#pragma unroll 4
    for (int k = 0; k < TA::BK; ++k) {
      double a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = A_KM ? sa[k * TA::LD + tm + 16 * i] : sa[(tm + 16 * i) * TA::LD + k];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        b[j] = B_KM ? sb[k * TB::LD + tn + 16 * j] : sb[(tn + 16 * j) * TB::LD + k];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
    }
  }

  template <typename Epi>
  __device__ __forceinline__ void store(const Epi& epi, int m0, int n0, int M, int N, int z) {
    const int tm = threadIdx.x >> 4, tn = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = m0 + tm + 16 * i, c = n0 + tn + 16 * j;
        if (r < M && c < N) epi(r, c, z, static_cast<float>(acc[i][j]));
      }
  }
};

// Two neighbouring elements (p 8-byte aligned for fp32, 4 for bf16).
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The epilogue of a dense layer, out = cd(relu(acc + bias)) with fp32 bias,
// (row, col, split, fp32 sum), and its pair form for columns c, c + 1 (c
// even): the encoder's FFN hidden f1 and both hidden layers of the scoring
// tower.
template <typename T>
struct EpiRelu {
  T* out;
  int ld;
  const float* bias;
  __device__ void operator()(int r, int c, int, float v) const {
    out[static_cast<size_t>(r) * ld + c] = from_f<T>(fmaxf(v + bias[c], 0.f));
  }
  __device__ void pair(int r, int c, int, float v0, float v1) const {
    store2(out + static_cast<size_t>(r) * ld + c, fmaxf(v0 + bias[c], 0.f),
           fmaxf(v1 + bias[c + 1], 0.f));
  }
};

// Split z's slice of a weight gradient, or group z's slice of a grouped
// product: part[z zstride + r ld + c] = C (fp32, not rounded).
struct EpiPartial {
  float* part;
  int ld;
  size_t zstride;
  __device__ void operator()(int r, int c, int z, float v) const {
    part[z * zstride + static_cast<size_t>(r) * ld + c] = v;
  }
  __device__ void pair(int r, int c, int z, float v0, float v1) const {
    store2(part + z * zstride + static_cast<size_t>(r) * ld + c, v0, v1);
  }
};

// Group z's slice of a grouped product rounded to T and stored in T:
// out[z zstride + r ld + c] = cd(C), the interaction forward's V = cd(sc W).
template <typename T>
struct EpiStoreCd {
  T* out;
  int ld;
  size_t zstride;
  __device__ void operator()(int r, int c, int z, float v) const {
    out[z * zstride + static_cast<size_t>(r) * ld + c] = from_f<T>(v);
  }
  __device__ void pair(int r, int c, int z, float v0, float v1) const {
    store2(out + z * zstride + static_cast<size_t>(r) * ld + c, v0, v1);
  }
};

// C = A B over the block's (m, n) tile, group and split (z = g splits + s);
// see the file's note. lda / ldb are the row strides of A and B as stored.
template <typename T, bool A_KM, bool B_KM, typename Epi>
__global__ void __launch_bounds__(kThreads)
tile_product(const T* __restrict__ A, int lda, const T* __restrict__ B, int ldb, int M, int N,
             int K, int chunk, int splits, size_t a_gs, size_t b_gs, Epi epi) {
  using C = Core<T, A_KM, B_KM>;
  using TA = typename C::TA;
  using TB = typename C::TB;
  constexpr int BK = TA::BK;
  extern __shared__ __align__(16) unsigned char smem_raw[];  // kStages slices of A, then of B
  T* const sa0 = reinterpret_cast<T*>(smem_raw);
  T* const sb0 = sa0 + kStages * TA::ELEMS;

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, z = blockIdx.z;
  const int grp = z / splits;
  A += grp * a_gs;
  B += grp * b_gs;
  const int kb = (z - grp * splits) * chunk, ke = min(K, kb + chunk);
  const int steps = ke > kb ? (ke - kb + BK - 1) / BK : 0;

  auto load = [&](int t) {  // slice t into buffer t % kStages
    T* a = sa0 + (t % kStages) * TA::ELEMS;
    T* b = sb0 + (t % kStages) * TB::ELEMS;
    const int k0 = kb + t * BK;
    if (A_KM)
      stage<T, TA>(a, A, lda, k0, ke, m0, M);
    else
      stage<T, TA>(a, A, lda, m0, M, k0, ke);
    if (B_KM)
      stage<T, TB>(b, B, ldb, k0, ke, n0, N);
    else
      stage<T, TB>(b, B, ldb, n0, N, k0, ke);
  };

  C core;
  core.zero();
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < steps) load(t);
    cp_async_commit();  // one group a slice, empty past the last
  }
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kStages - 2>();  // slice t has landed
    __syncthreads();  // and every warp is done with slice t - 1, whose buffer is refilled next
    if (t + kStages - 1 < steps) load(t + kStages - 1);
    cp_async_commit();
    core.step(sa0 + (t % kStages) * TA::ELEMS, sb0 + (t % kStages) * TB::ELEMS);
  }
  core.store(epi, m0, n0, M, N, z);
}

// Launch C = A B with epilogue epi over `splits` chunks of K (chunk a
// multiple of 64), for `groups` products whose operands lie a_gs and b_gs
// elements apart; returns a cudaError_t.
template <typename T, bool A_KM, bool B_KM, typename Epi>
int launch_product(const T* A, const T* B, int M, int N, int K, int splits, int chunk, Epi epi,
                   cudaStream_t stream, int groups = 1, size_t a_gs = 0, size_t b_gs = 0) {
  using C = Core<T, A_KM, B_KM>;
  constexpr int smem = kStages * (C::TA::ELEMS + C::TB::ELEMS) * sizeof(T);
  auto kern = tile_product<T, A_KM, B_KM, Epi>;
  // above 48 KB only when asked for; asked at every launch, as a static
  // flag here would be one symbol for every library in a process
  const cudaError_t set =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int lda = A_KM ? M : K, ldb = B_KM ? N : K;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, groups * splits);
  kern<<<grid, kThreads, smem, stream>>>(A, lda, B, ldb, M, N, K, chunk, splits, a_gs, b_gs,
                                         epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mma
}  // namespace ctr
