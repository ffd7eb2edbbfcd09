// The gradient of a gather, summed in a fixed order, for Hopper (sm_90a).
//
// Replaces no TPU kernel. It takes the place of a library backward,
// torch.ops.aten.embedding_dense_backward, on the port's training path: the
// table gradient of every gather (models/trunk.py::TableLookup, which the
// merged per-table lookup and the gathered strategy's row buffers share) and
// the row-sharded lookup's local backward (parallel/embedding.py). The JAX
// package takes the same function as jnp.zeros(...).at[ids].add(cot)
// (ctr_recommendation_tpu/training/sparse.py::multi_feature_lookup), which a
// TPU sums in a fixed order. The library backward sums the cotangents of a
// row in an order that changes from call to call on an H100, so a training
// step there was not a function of its seed.
//
//   out (rows, E) fp32 = zeros(rows, E).index_add(0, ids, cot),
//   ids in [0, rows); an id outside adds nothing (never a fault)
//
// The caller sorts the ids, stably (keys int32; perm int64: a sorted
// position's cotangent row). Two launches, no atomics:
//   1. chunk_sums: one block a chunk of kChunk sorted positions. Each thread
//      owns column units (4 columns when E % 4 == 0) and sums the chunk's
//      runs of equal ids in sorted order. A run wholly inside the chunk is
//      its row's whole sum, stored in out. A run cut by the chunk's start
//      stores its part in head[chunk], one cut by its end in tail[chunk].
//   2. row_sums: one warp a row. Two binary searches give the row's sorted
//      span [lo, hi). No ids: zeros. One chunk: pass 1 stored it. Else
//      tail[k0] + head[k0 + 1] + ... + head[k1], added in that order.
// Every sum runs in an order fixed by the sorted ids and kChunk alone, so
// the same inputs give the same bits on every call. A pad id that repeats
// tens of thousands of times in a batch of histories spans hundreds of
// chunks: pass 1 spreads it over as many blocks, and pass 2 adds its
// partials with 16 loads in flight a lane.
//
// Bound on an H100: bytes. The ids read once (8 B), the cotangents once (4E
// B an id), the gradient written once (4E B a row): at the item table's
// step (86,016 ids, 91,777 rows, E=128) 91.7 MB, 27 us at 3.35 TB/s. The
// sort (torch.sort) and the partials (2 x 4E B a chunk) come on top.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace ctr {

constexpr int kChunk = 128;     // sorted positions a block of pass 1 sums
constexpr int kLoads = 8;       // cotangent loads in flight a thread, pass 1
constexpr int kPartials = 16;   // partial loads in flight a lane, pass 2
constexpr int kRowWarps = 8;    // rows a block of pass 2: one warp each

template <int V> struct Unit;
template <> struct Unit<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ void add(T& a, const T& b) { a += b; }
};
template <> struct Unit<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ void add(T& a, const T& b) {
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
};

// Pass 1. keys (n) sorted, perm (n); cot (ids, E) as units of V floats;
// out (rows, E); head and tail (chunks, E).
template <int V>
__global__ void __launch_bounds__(256)
chunk_sums(const int* __restrict__ keys, const int64_t* __restrict__ perm,
           const float* __restrict__ cot, float* __restrict__ out, float* __restrict__ head,
           float* __restrict__ tail, int n, int rows, int units) {
  using U = Unit<V>;
  using T = typename U::T;
  __shared__ int key_s[kChunk];
  __shared__ int64_t perm_s[kChunk];
  const int chunk = blockIdx.x;
  const int a = chunk * kChunk;
  const int len = min(n - a, kChunk);
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    key_s[i] = keys[a + i];
    perm_s[i] = perm[a + i];
  }
  __syncthreads();
  // the chunk's first run began in the chunk before; its last runs on
  const bool cut_front = a > 0 && keys[a - 1] == key_s[0];
  const bool cut_back = a + len < n && keys[a + len] == key_s[len - 1];
  const T* c = reinterpret_cast<const T*>(cot);
  T* o = reinterpret_cast<T*>(out);
  T* h = reinterpret_cast<T*>(head) + static_cast<size_t>(chunk) * units;
  T* t = reinterpret_cast<T*>(tail) + static_cast<size_t>(chunk) * units;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    T acc = U::zero();
    bool first = true;  // the run being summed is the chunk's first
    for (int i0 = 0; i0 < len; i0 += kLoads) {
      T v[kLoads];
#pragma unroll
      for (int j = 0; j < kLoads; ++j)
        v[j] = i0 + j < len ? __ldg(c + perm_s[i0 + j] * units + u) : U::zero();
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const int i = i0 + j;
        if (i < len) {
          U::add(acc, v[j]);
          const bool last = i == len - 1;
          if (last || key_s[i + 1] != key_s[i]) {  // the run of key_s[i] ends here
            const int row = key_s[i];
            const bool to_head = first && cut_front, to_tail = last && cut_back;
            if (row >= 0 && row < rows) {
              if (to_head) h[u] = acc;
              if (to_tail) t[u] = acc;
              if (!to_head && !to_tail) o[static_cast<size_t>(row) * units + u] = acc;
            }
            acc = U::zero();
            first = false;
          }
        }
      }
    }
  }
}

// The first position of the sorted keys (n) holding a key >= v.
__device__ __forceinline__ int lower_bound(const int* __restrict__ keys, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(keys + mid) < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Pass 2: every row of out, one warp each.
template <int V>
__global__ void __launch_bounds__(kRowWarps * 32)
row_sums(const int* __restrict__ keys, const float* __restrict__ head,
         const float* __restrict__ tail, float* __restrict__ out, int n, int rows, int units) {
  using U = Unit<V>;
  using T = typename U::T;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp: the row is the warp's
  const int lo = lower_bound(keys, n, row), hi = lower_bound(keys, n, row + 1);
  T* o = reinterpret_cast<T*>(out) + static_cast<size_t>(row) * units;
  if (lo == hi) {
    for (int u = lane; u < units; u += 32) o[u] = U::zero();
    return;
  }
  const int k0 = lo / kChunk, k1 = (hi - 1) / kChunk;
  if (k0 == k1) return;  // pass 1 stored the whole sum
  const T* h = reinterpret_cast<const T*>(head);
  const T* t = reinterpret_cast<const T*>(tail);
  for (int u = lane; u < units; u += 32) {
    T s = t[static_cast<size_t>(k0) * units + u];
    int k = k0 + 1;
    for (; k + kPartials - 1 <= k1; k += kPartials) {
      T v[kPartials];
#pragma unroll
      for (int j = 0; j < kPartials; ++j) v[j] = h[static_cast<size_t>(k + j) * units + u];
#pragma unroll
      for (int j = 0; j < kPartials; ++j) U::add(s, v[j]);
    }
    for (; k <= k1; ++k) U::add(s, h[static_cast<size_t>(k) * units + u]);
    o[u] = s;
  }
}

template <int V>
int launch(const int* keys, const int64_t* perm, const float* cot, float* out, float* head,
           float* tail, int n, int rows, int e, cudaStream_t s) {
  const int units = e / V;
  if (n > 0) {
    const int threads = units >= 256 ? 256 : (units + 31) / 32 * 32;
    chunk_sums<V><<<(n + kChunk - 1) / kChunk, threads, 0, s>>>(keys, perm, cot, out, head, tail,
                                                                  n, rows, units);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  row_sums<V><<<(rows + kRowWarps - 1) / kRowWarps, kRowWarps * 32, 0, s>>>(keys, head, tail,
                                                                             out, n, rows, units);
  return static_cast<int>(cudaGetLastError());
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace ctr

// The shape predicate (ops/cuda/table_grad.py::fits): positions, chunk
// starts and rows + 1 in int32.
extern "C" int table_grad_fits(long long n, long long rows, long long e) {
  return n >= 0 && n <= 2147483647LL - ctr::kChunk && rows >= 1 && rows <= 2147483646LL &&
         e >= 1 && e <= 2147483647LL;
}

// Floats of head and of tail for n ids of width E.
extern "C" size_t table_grad_scratch(int n, int e) {
  return static_cast<size_t>((n + ctr::kChunk - 1) / ctr::kChunk) * e;
}

// out (rows, E) = the rows' sums of cot (n, E) over keys (n, sorted, int32)
// through perm (n, int64); head and tail hold table_grad_scratch floats each.
// Two launches (one when n == 0). Returns the first cudaError_t.
extern "C" int table_grad(const int* keys, const int64_t* perm, const float* cot, float* out,
                          float* head, float* tail, int n, int rows, int e, void* stream) {
  if (!table_grad_fits(n, rows, e)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = e % 4 == 0 && ctr::aligned16(cot) && ctr::aligned16(out) &&
                   ctr::aligned16(head) && ctr::aligned16(tail);
  return vec ? ctr::launch<4>(keys, perm, cot, out, head, tail, n, rows, e, s)
             : ctr::launch<1>(keys, perm, cot, out, head, tail, n, rows, e, s);
}
