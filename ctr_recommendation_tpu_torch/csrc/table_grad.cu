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
// The ids and cotangents come as up to kMaxSegments segments, read where the
// caller's autograd left them (a segment's cotangent rows may sit on a
// two-level grid of strides: a transposed (S, B, E) view). Positions count
// through the segments in list order, so a call on segments is the call on
// their concatenation, bit for bit. No floating-point atomics: every sum
// runs in an order fixed by the ids and the shapes alone, so the same inputs
// give the same bits on every call. table_grad_plan picks one of two paths
// from the shapes (ops/cuda/table_grad.py::plan mirrors it):
//
// shared (rows x E x 4 B <= kSharedBytes; the likes_level table, 129 x 128):
//   no sort. 1. slice_sums: one block a slice of slice_len positions holds
//   the whole (rows, E) table in shared memory; thread (g, u) owns column
//   unit u of the rows r with r % groups == g, so each accumulator has one
//   owner, and adds the slice's cotangents of its rows in position order.
//   One slice: stored as out.
//   2. reduce_slices (more than one slice): each element of out is the
//   slices' partials added in slice order.
// sorted (larger tables; the item table, 91,777 x 128): 1. the key sort:
//   the ids as int32 keys in [0, rows] (an id out of range as rows: sorted
//   last, never stored), sorted stably by an LSD radix sort of kDigitBits a
//   pass (tile histograms with integer counts, each digit's tile prefixes,
//   a scatter that ranks each key among its tile's keys of its digit in
//   position order):
//   an ordering, not a sum; 3 launches a pass, 2 passes for rows < 2^18.
//   2. chunk_sums: one block of kWarps warps a chunk of kChunk sorted
//   positions, each warp a fixed sub-chunk of kSub, each lane a column unit
//   (4 columns when E % 4 == 0), kLoads gathered loads in flight a lane.
//   A run of equal keys inside a sub-chunk is summed in sorted order and
//   stored as its row; the pieces of a run cut by a sub-chunk's edges are
//   added in warp order; a run cut by the chunk's start stores its part in
//   head[chunk], one cut by its end in tail[chunk]. Each run's first and
//   last position write its row's span [lo, hi) into an int2 table of rows
//   entries, never cleared: 3. row_sums reads a row's span in O(1) and
//   believes it only when keys[lo] is the row (an untouched row's entry is
//   whatever memory held, and no position of it holds the row's key):
//   zeros for an untouched row, nothing for a run chunk_sums stored whole,
//   else tail[k0] + head[k0 + 1] + ... + head[k1], added in chunk order.
//   The pad id that repeats ~4e4 times in a batch of histories spans
//   hundreds of chunks: chunk_sums spreads it over as many blocks, and a
//   chain that long is added by a block of its own at the head of
//   row_sums' grid, kChainParts partials staged at a time, while the rest
//   of the pass writes rows.
//
// Bound on an H100: bytes. The ids read once (8 B), the cotangents once (4E
// B an id), the gradient written once (4E B a row): at the item table's
// step (86,016 ids, 91,777 rows, E=128) 91.7 MB, 27 us at 3.35 TB/s. The
// key sort (0.7 MB a pass) and the partials come on top.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace ctr {

constexpr int kMaxSegments = 8;         // (ids, cot) segments a call
// the shared path
constexpr long long kSharedBytes = 160 * 1024;  // the largest (rows, E) fp32 table
constexpr int kSlice = 128;             // fewest positions a slice
constexpr int kMaxSlices = 256;         // most slices a call
constexpr int kStage = 256;             // positions a slice stages at once
constexpr int kSliceThreads = kStage;   // threads a block of slice_sums: one a staged position
constexpr int kSliceWarps = kSliceThreads / 32;
constexpr int kSliceLoads = 16;         // cotangent loads in flight a thread, slice_sums
constexpr int kMaxGroups = 32;          // row groups a block of slice_sums
constexpr int kReduceThreads = 256;
constexpr int kReduceLoads = 32;        // partial loads in flight a thread, reduce_slices
// the sorted path
constexpr int kDigitBits = 9;           // key bits a pass of the key sort
constexpr int kDigits = 1 << kDigitBits;
constexpr int kSortThreads = 256;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSortItems = 4;           // keys a thread of a sort tile
constexpr int kSortTile = kSortThreads * kSortItems;
constexpr int kWarps = 8;               // warps a block of chunk_sums
constexpr int kSub = 32;                // sorted positions a warp of chunk_sums
constexpr int kChunk = kWarps * kSub;   // sorted positions a block of chunk_sums
constexpr int kLoads = 16;              // cotangent loads in flight a lane, chunk_sums
constexpr int kRowWarps = 8;            // warps a block of row_sums
constexpr int kRowsPerWarp = 8;         // rows a warp of row_sums
constexpr int kPartials = 16;           // most chunk partials a row_sums warp adds itself
constexpr int kChainParts = 64;         // partials a row_sums chain block stages at once

// The segments: segment k holds positions [start[k], start[k + 1]); its
// position q (from its start) reads ids[k][q] and the cotangent row at
// cot[k] + (q / inner[k]) so[k] + (q % inner[k]) si[k] floats.
struct Segs {
  const int64_t* ids[kMaxSegments];
  const float* cot[kMaxSegments];
  long long start[kMaxSegments + 1];
  long long inner[kMaxSegments], so[kMaxSegments], si[kMaxSegments];
  int count;
};

__device__ __forceinline__ int seg_of(const Segs& s, long long p) {
  int k = 0;
  while (k + 1 < s.count && p >= s.start[k + 1]) ++k;
  return k;
}

__device__ __forceinline__ const float* cot_row(const Segs& s, int k, long long p) {
  const long long q = p - s.start[k];
  return s.cot[k] + (q / s.inner[k]) * s.so[k] + (q % s.inner[k]) * s.si[k];
}

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

// ---- the shared path ----

// One block a slice [slice * len, ...): its sums over every row in shared
// memory, then stored at dst + slice * rows * units (out itself when one
// slice). Thread (g, u) = (t / units, t % units), g < groups, owns column
// unit u of the rows r with r % groups == g: each stage of kStage
// positions is split into one list a group, in position order (ballots
// and a block scan), and each thread adds its group's positions in that
// order, kSliceLoads loads in flight.
template <int V>
__global__ void __launch_bounds__(kSliceThreads)
slice_sums(Segs s, float* __restrict__ dst, long long n, int rows, int units, int groups,
           long long len) {
  using U = Unit<V>;
  using T = typename U::T;
  extern __shared__ float4 tbl4[];
  T* tbl = reinterpret_cast<T*>(tbl4);
  __shared__ int row_s[kStage];
  __shared__ const float* src_s[kStage];
  __shared__ short list_s[kStage];
  __shared__ int off_s[kMaxGroups * kSliceWarps + 1];
  __shared__ int warp_s[kSliceWarps];
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const long long cells = static_cast<long long>(rows) * units * V;
  const long long a = blockIdx.x * len, b = min(a + len, n);
  for (long long q = tid; q < cells / 4; q += kSliceThreads)
    tbl4[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  float* tblf = reinterpret_cast<float*>(tbl4);
  for (long long q = cells / 4 * 4 + tid; q < cells; q += kSliceThreads) tblf[q] = 0.f;
  const int g = tid / units, u = tid % units;  // this thread's group and unit
  for (long long st = a; st < b; st += kStage) {
    const int m = static_cast<int>(min(static_cast<long long>(kStage), b - st));
    __syncthreads();  // the table zeroed; the last stage's lists read
    int mine = -1;  // the group of position tid of the stage, -1 for none
    if (tid < m) {
      const long long p = st + tid;
      const int k = seg_of(s, p);
      const int64_t id = s.ids[k][p - s.start[k]];
      const int row = id >= 0 && id < rows ? static_cast<int>(id) : -1;
      row_s[tid] = row;
      src_s[tid] = cot_row(s, k, p);
      mine = row >= 0 ? row % groups : -1;
    }
    // each position's rank among the stage's positions of its group, in order
    int rank = 0;
    for (int gg = 0; gg < groups; ++gg) {
      const unsigned mask = __ballot_sync(0xffffffffu, mine == gg);
      if (mine == gg) rank = __popc(mask & ((1u << lane) - 1));
      if (lane == 0) off_s[gg * kSliceWarps + w] = __popc(mask);
    }
    __syncthreads();
    // exclusive scan of off_s over (group, warp), group-major: one entry a thread
    const int cells_g = groups * kSliceWarps;
    int x = tid < cells_g ? off_s[tid] : 0;
    int incl = x;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) warp_s[w] = incl;
    __syncthreads();
    int before = 0;
    for (int ww = 0; ww < w; ++ww) before += warp_s[ww];
    if (tid < cells_g) off_s[tid] = before + incl - x;
    if (tid == kSliceThreads - 1) off_s[cells_g] = before + incl;
    __syncthreads();
    if (mine >= 0) list_s[off_s[mine * kSliceWarps + w] + rank] = static_cast<short>(tid);
    __syncthreads();
    if (g < groups) {  // one unit a thread, or with one group every kSliceThreads-th
      const int q0 = off_s[g * kSliceWarps], q1 = off_s[(g + 1) * kSliceWarps];
      for (int uu = u; uu < units; uu += kSliceThreads) {
        for (int q = q0; q < q1; q += kSliceLoads) {
          T v[kSliceLoads];
#pragma unroll
          for (int j = 0; j < kSliceLoads; ++j)
            v[j] = q + j < q1 ? __ldg(reinterpret_cast<const T*>(src_s[list_s[q + j]]) + uu)
                              : U::zero();
#pragma unroll
          for (int j = 0; j < kSliceLoads; ++j)
            if (q + j < q1)
              U::add(tbl[static_cast<long long>(row_s[list_s[q + j]]) * units + uu], v[j]);
        }
      }
    }
  }
  __syncthreads();
  float* d = dst + blockIdx.x * cells;
  if (cells % 4 == 0 && reinterpret_cast<uintptr_t>(d) % 16 == 0) {
    float4* d4 = reinterpret_cast<float4*>(d);
    for (long long q = tid; q < cells / 4; q += kSliceThreads) d4[q] = tbl4[q];
  } else {
    for (long long q = tid; q < cells; q += kSliceThreads) d[q] = tblf[q];
  }
}

// out[q] = part[0][q] + part[1][q] + ... + part[slices - 1][q], in that order.
template <int V>
__global__ void __launch_bounds__(kReduceThreads)
reduce_slices(const float* __restrict__ part, float* __restrict__ out, long long units,
              int slices) {
  using U = Unit<V>;
  using T = typename U::T;
  const long long q = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (q >= units) return;
  const T* p = reinterpret_cast<const T*>(part);
  T acc = p[q];
  int k = 1;
  for (; k + kReduceLoads - 1 < slices; k += kReduceLoads) {
    T v[kReduceLoads];
#pragma unroll
    for (int j = 0; j < kReduceLoads; ++j) v[j] = p[(k + j) * units + q];
#pragma unroll
    for (int j = 0; j < kReduceLoads; ++j) U::add(acc, v[j]);
  }
  for (; k < slices; ++k) U::add(acc, p[k * units + q]);
  reinterpret_cast<T*>(out)[q] = acc;
}

// ---- the sorted path ----

// The key sort: a stable LSD radix sort of the int32 keys in [0, rows],
// kDigitBits a pass, each pass three launches: tile histograms
// (hist[digit * tiles + tile]), each digit's tile prefixes and total, and a
// stable scatter.

// The tile's histogram of digit (key >> shift) & (kDigits - 1) into hist.
__device__ __forceinline__ void tile_hist(const int (&key)[kSortItems], const bool (&ok)[kSortItems],
                                          int* cnt, int* __restrict__ hist, int shift,
                                          int tiles) {
#pragma unroll
  for (int r = 0; r < kSortItems; ++r)
    if (ok[r]) atomicAdd(cnt + ((key[r] >> shift) & (kDigits - 1)), 1);  // integer counts
  __syncthreads();
  for (int d = threadIdx.x; d < kDigits; d += kSortThreads) hist[d * tiles + blockIdx.x] = cnt[d];
}

// keys[p] = the id at position p when in [0, rows), else rows; the first
// pass's tile histograms.
__global__ void __launch_bounds__(kSortThreads)
make_keys(Segs s, int* __restrict__ keys, int* __restrict__ hist, int n, int rows, int tiles) {
  __shared__ int cnt[kDigits];
  for (int d = threadIdx.x; d < kDigits; d += kSortThreads) cnt[d] = 0;
  int key[kSortItems];
  bool ok[kSortItems];
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    const int p = blockIdx.x * kSortTile + r * kSortThreads + threadIdx.x;
    ok[r] = p < n;
    int64_t id = -1;
    if (ok[r]) {
      const int k = seg_of(s, p);
      id = s.ids[k][p - s.start[k]];
    }
    key[r] = id >= 0 && id < rows ? static_cast<int>(id) : rows;
    if (ok[r]) keys[p] = key[r];
  }
  __syncthreads();
  tile_hist(key, ok, cnt, hist, 0, tiles);
}

// A later pass's tile histograms.
__global__ void __launch_bounds__(kSortThreads)
key_hist(const int* __restrict__ keys, int* __restrict__ hist, int n, int shift, int tiles) {
  __shared__ int cnt[kDigits];
  for (int d = threadIdx.x; d < kDigits; d += kSortThreads) cnt[d] = 0;
  int key[kSortItems];
  bool ok[kSortItems];
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    const int p = blockIdx.x * kSortTile + r * kSortThreads + threadIdx.x;
    ok[r] = p < n;
    key[r] = ok[r] ? keys[p] : 0;
  }
  __syncthreads();
  tile_hist(key, ok, cnt, hist, shift, tiles);
}

// Block-wide exclusive scan of one int a thread (kSortThreads threads);
// the total in *total.
__device__ __forceinline__ int block_scan(int x, int* warp_s, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_s[w] = incl;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int ww = 0; ww < kSortWarps; ++ww) {
    const int v = warp_s[ww];
    before += ww < w ? v : 0;
    all += v;
  }
  __syncthreads();
  *total = all;
  return before + incl - x;
}

// One block a digit: hist[digit][tile] replaced by its exclusive prefix over
// the digit's tiles; tot[digit] the digit's count.
__global__ void __launch_bounds__(kSortThreads)
digit_scan(int* __restrict__ hist, int* __restrict__ tot, int tiles) {
  __shared__ int warp_s[kSortWarps];
  int* h = hist + static_cast<long long>(blockIdx.x) * tiles;
  int carry = 0;
  for (int t0 = 0; t0 < tiles; t0 += kSortThreads) {
    const int t = t0 + threadIdx.x;
    const int x = t < tiles ? h[t] : 0;
    int total;
    const int ex = block_scan(x, warp_s, &total);
    if (t < tiles) h[t] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) tot[blockIdx.x] = carry;
}

// One pass's stable scatter of a tile: each key's rank among the tile's
// keys of its digit, in position order (warp w takes the tile's w-th 256
// keys, 32 at a time: __match_any_sync ranks a round, per-warp counts the
// rounds, a prefix over the warps the tile), then its place: the digits
// before it (a scan of tot), the digit's keys in earlier tiles (hist), its
// rank. vals_in nullptr: the values are the positions.
__global__ void __launch_bounds__(kSortThreads)
key_scatter(const int* __restrict__ keys_in, const int* __restrict__ vals_in,
            int* __restrict__ keys_out, int* __restrict__ vals_out, const int* __restrict__ hist,
            const int* __restrict__ tot, int n, int shift, int tiles) {
  __shared__ unsigned short wcnt[kSortWarps][kDigits];
  __shared__ int base_s[kDigits];
  __shared__ int warp_s[kSortWarps];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p0 = blockIdx.x * kSortTile + w * 32 * kSortItems + lane;
  int key[kSortItems], val[kSortItems], rank[kSortItems];
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    const int p = p0 + 32 * r;
    key[r] = p < n ? keys_in[p] : 0;
    val[r] = p < n ? (vals_in ? vals_in[p] : p) : 0;
  }
  // the digits' bases: kDigits / kSortThreads digits a thread
  constexpr int kPer = kDigits / kSortThreads;
  int c[kPer], sum = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    c[j] = tot[threadIdx.x * kPer + j];
    sum += c[j];
  }
  int total;
  int run = block_scan(sum, warp_s, &total);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int d = threadIdx.x * kPer + j;
    base_s[d] = run + hist[d * tiles + blockIdx.x];
    run += c[j];
#pragma unroll
    for (int ww = 0; ww < kSortWarps; ++ww) wcnt[ww][d] = 0;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    const bool ok = p0 + 32 * r < n;
    const int d = ok ? (key[r] >> shift) & (kDigits - 1) : kDigits;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int cur = ok ? wcnt[w][d] : 0;
    __syncwarp();
    if (ok && (peers & below) == 0) wcnt[w][d] = static_cast<unsigned short>(cur + __popc(peers));
    __syncwarp();
    rank[r] = cur + __popc(peers & below);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < kDigits; d += kSortThreads) {  // exclusive over the warps
    int acc = 0;
#pragma unroll
    for (int ww = 0; ww < kSortWarps; ++ww) {
      const int x = wcnt[ww][d];
      wcnt[ww][d] = static_cast<unsigned short>(acc);
      acc += x;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    if (p0 + 32 * r < n) {
      const int d = (key[r] >> shift) & (kDigits - 1);
      const int dst = base_s[d] + wcnt[w][d] + rank[r];
      keys_out[dst] = key[r];
      vals_out[dst] = val[r];
    }
  }
}

// Pass 1: keys (n) sorted, perm (n) their positions; out (rows, E), head and
// tail (chunks, E) as units of V floats; spans (rows) int2.
template <int V>
__global__ void __launch_bounds__(kWarps * 32)
chunk_sums(Segs s, const int* __restrict__ keys, const int* __restrict__ perm,
           float* __restrict__ out, float* __restrict__ head, float* __restrict__ tail,
           int2* __restrict__ spans, int n, int rows, int units) {
  using U = Unit<V>;
  using T = typename U::T;
  __shared__ int key_s[kChunk + 2];  // key_s[i + 1]: sorted position a + i; -1 off the ends
  __shared__ const float* src_s[kChunk];
  __shared__ T first_s[kWarps][32], last_s[kWarps][32];
  const int chunk = blockIdx.x;
  const int a = chunk * kChunk;
  const int len = min(n - a, kChunk);
  for (int i = threadIdx.x; i < len + 2; i += blockDim.x) {
    const int p = a - 1 + i;
    key_s[i] = p >= 0 && p < n ? keys[p] : -1;
  }
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const int p = perm[a + i];
    src_s[i] = cot_row(s, seg_of(s, p), p);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < len; i += blockDim.x) {  // the runs' spans
    const int key = key_s[i + 1];
    if (key < rows) {
      if (key_s[i] != key) spans[key].x = a + i;
      if (key_s[i + 2] != key) spans[key].y = a + i + 1;
    }
  }
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b0 = w * kSub, b1 = min(b0 + kSub, len);  // the warp's positions, local
  // the warp's first run began before b0; its last runs on past b1
  const bool front = b0 < len && key_s[b0] == key_s[b0 + 1];
  const bool back = b0 < len && key_s[b1 + 1] == key_s[b1];
  T* o = reinterpret_cast<T*>(out);
  for (int u0 = 0; u0 < units; u0 += 32) {
    const int u = u0 + lane;
    const bool active = u < units;
    T acc = U::zero();
    bool first = true;  // the run being summed is the warp's first
    for (int i0 = b0; i0 < b1; i0 += kLoads) {
      T v[kLoads];
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const int i = i0 + j;
        v[j] = i < b1 && active ? __ldg(reinterpret_cast<const T*>(src_s[i]) + u) : U::zero();
      }
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const int i = i0 + j;
        if (i < b1) {
          U::add(acc, v[j]);
          const bool last = i == b1 - 1;
          if (last || key_s[i + 2] != key_s[i + 1]) {  // the run of key_s[i + 1] ends here
            const int key = key_s[i + 1];
            if (first && front) first_s[w][lane] = acc;
            else if (last && back) last_s[w][lane] = acc;
            else if (key < rows && active) o[static_cast<size_t>(key) * units + u] = acc;
            acc = U::zero();
            first = false;
          }
        }
      }
    }
    __syncthreads();
    if (w == 0 && active) {  // the runs cut by sub-chunk edges, added in warp order
      T run = U::zero();
      bool at_head = false;  // the open run began before the chunk
      bool open = false;
      for (int ww = 0; ww < kWarps; ++ww) {
        const int c0 = ww * kSub, c1 = min(c0 + kSub, len);
        if (c0 >= len) break;
        const bool fr = key_s[c0] == key_s[c0 + 1];
        const bool bk = key_s[c1 + 1] == key_s[c1];
        const bool one = key_s[c0 + 1] == key_s[c1];  // the sub-chunk is one run
        if (fr) {
          if (ww == 0) {
            run = first_s[0][lane];
            at_head = true;
          } else {
            U::add(run, first_s[ww][lane]);
          }
          open = one && bk;
          if (!open) {  // the run ends in sub-chunk ww
            const int key = key_s[c0 + 1];
            if (key < rows) {
              if (at_head) reinterpret_cast<T*>(head)[static_cast<size_t>(chunk) * units + u] = run;
              else o[static_cast<size_t>(key) * units + u] = run;
            }
          }
        }
        if (bk && !(one && fr)) {
          run = last_s[ww][lane];
          at_head = false;
          open = true;
        }
      }
      if (open) {  // the chunk's last run goes on past it
        T* dst = reinterpret_cast<T*>(at_head ? head : tail);
        dst[static_cast<size_t>(chunk) * units + u] = run;
      }
    }
    __syncthreads();
  }
}

// Pass 2. The first chain_blocks blocks: block b adds the partials of the
// run that crosses chunk b's end and began in chunk b, when it crosses
// more than kPartials chunks (the pad id's): tail[b], head[b + 1], ...,
// head[k1], in that order, the whole block staging kChainParts partials at
// a time in shared memory while the rest of the pass writes rows. The
// others: every other row of out, kRowsPerWarp a warp.
template <int V>
__global__ void __launch_bounds__(kRowWarps * 32)
row_sums(const int* __restrict__ keys, const int2* __restrict__ spans,
         const float* __restrict__ head, const float* __restrict__ tail, float* __restrict__ out,
         int n, int rows, int units, int chain_blocks) {
  using U = Unit<V>;
  using T = typename U::T;
  __shared__ T chain_s[kChainParts][32];
  const T* h = reinterpret_cast<const T*>(head);
  const T* t = reinterpret_cast<const T*>(tail);
  const int lane = threadIdx.x & 31;
  if (static_cast<int>(blockIdx.x) < chain_blocks) {
    const int p = (blockIdx.x + 1) * kChunk - 1;  // chunk b's last position
    if (p + 1 >= n) return;
    const int key = keys[p];
    if (key >= rows || keys[p + 1] != key) return;
    const int2 sp = spans[key];
    const int k0 = sp.x / kChunk, k1 = (sp.y - 1) / kChunk;
    if (k0 != static_cast<int>(blockIdx.x) || k1 - k0 <= kPartials) return;
    T* o = reinterpret_cast<T*>(out) + static_cast<size_t>(key) * units;
    for (int u0 = 0; u0 < units; u0 += 32) {
      const int tu = min(32, units - u0);
      T acc = threadIdx.x < tu ? t[static_cast<size_t>(k0) * units + u0 + threadIdx.x]
                               : U::zero();
      for (int k = k0 + 1; k <= k1; k += kChainParts) {
        const int np = min(kChainParts, k1 + 1 - k);
        __syncthreads();  // the last tile added
        for (int i = threadIdx.x; i < np * 32; i += blockDim.x) {
          const int pi = i >> 5, ui = i & 31;
          if (ui < tu) chain_s[pi][ui] = h[static_cast<size_t>(k + pi) * units + u0 + ui];
        }
        __syncthreads();
        if (threadIdx.x < tu)
          for (int pi = 0; pi < np; ++pi) U::add(acc, chain_s[pi][threadIdx.x]);
      }
      if (threadIdx.x < tu) o[u0 + threadIdx.x] = acc;
    }
    return;
  }
  const long long base =
      (static_cast<long long>(blockIdx.x - chain_blocks) * kRowWarps + (threadIdx.x >> 5)) *
      kRowsPerWarp;
  // lane j < kRowsPerWarp reads row base + j's span: k0 = -1 zeros, -2 no
  // store (stored by pass 1 or a chain block, or past the table), else
  // chunks k0..k1
  int k0 = -2, k1 = -2;
  if (lane < kRowsPerWarp && base + lane < rows) {
    const int r = static_cast<int>(base + lane);
    const int2 sp = spans[r];
    if (sp.x >= 0 && sp.x < sp.y && sp.y <= n && __ldg(keys + sp.x) == r) {
      k0 = sp.x / kChunk;
      k1 = (sp.y - 1) / kChunk;
      if (k0 == k1 || k1 - k0 > kPartials) k0 = k1 = -2;
    } else {
      k0 = -1;
    }
  }
#pragma unroll 1
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int c0 = __shfl_sync(0xffffffffu, k0, j), c1 = __shfl_sync(0xffffffffu, k1, j);
    if (c0 == -2) continue;
    T* o = reinterpret_cast<T*>(out) + static_cast<size_t>(base + j) * units;
    if (c0 == -1) {
      for (int u = lane; u < units; u += 32) o[u] = U::zero();
      continue;
    }
    for (int u = lane; u < units; u += 32) {  // at most kPartials partials
      T v[kPartials];
#pragma unroll
      for (int i = 0; i < kPartials; ++i)
        v[i] = c0 + 1 + i <= c1 ? h[static_cast<size_t>(c0 + 1 + i) * units + u] : U::zero();
      T acc = t[static_cast<size_t>(c0) * units + u];
#pragma unroll
      for (int i = 0; i < kPartials; ++i)
        if (c0 + 1 + i <= c1) U::add(acc, v[i]);
      o[u] = acc;
    }
  }
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// The segment table from the C argument: seg holds six numbers a segment,
// the ids' address, the cotangent's address, count, inner, so, si.
inline Segs make_segs(const long long* seg, int segments) {
  Segs s{};
  s.count = segments;
  s.start[0] = 0;
  for (int k = 0; k < segments; ++k) {
    const long long* g = seg + 6 * k;
    s.ids[k] = reinterpret_cast<const int64_t*>(static_cast<uintptr_t>(g[0]));
    s.cot[k] = reinterpret_cast<const float*>(static_cast<uintptr_t>(g[1]));
    s.start[k + 1] = s.start[k] + g[2];
    s.inner[k] = g[3] > 0 ? g[3] : 1;
    s.so[k] = g[4];
    s.si[k] = g[5];
  }
  return s;
}

// Whether every cotangent row of the segments lies on 16 bytes.
inline bool rows_aligned16(const Segs& s) {
  for (int k = 0; k < s.count; ++k)
    if (!aligned16(s.cot[k]) || s.so[k] % 4 != 0 || s.si[k] % 4 != 0) return false;
  return true;
}

// Passes of the key sort for keys in [0, rows].
inline int sort_passes(long long rows) {
  int bits = 1;
  while ((1LL << bits) <= rows) ++bits;
  return static_cast<int>(cdiv(bits, kDigitBits));
}

}  // namespace ctr

// The shape predicate (ops/cuda/table_grad.py::fits): positions, chunk
// starts and rows + 1 in int32; 1 to kMaxSegments segments.
extern "C" int table_grad_fits(long long n, long long rows, long long e, long long segments) {
  return n >= 0 && n <= 2147483647LL - ctr::kChunk && rows >= 1 && rows <= 2147483646LL &&
         e >= 1 && e <= 2147483647LL && segments >= 1 && segments <= ctr::kMaxSegments;
}

// The plan of a call (ops/cuda/table_grad.py::plan): out[0] the path (0
// shared, 1 sorted), out[1] its launches, out[2] its blocks (slices or
// chunks), out[3] positions a slice (shared), out[4] floats of partials,
// out[5] int32 scratch (sorted: the sort's keys and values twice, its tile
// histograms and digit counts, the span table). Returns 0, or 1 outside fits.
extern "C" int table_grad_plan(long long n, long long rows, long long e, long long* out) {
  if (!table_grad_fits(n, rows, e, 1)) return 1;
  if (e <= ctr::kSharedBytes / 4 / rows) {  // rows x E x 4 B within kSharedBytes
    const long long len =
        n == 0 ? 1 : ctr::cdiv(n, ctr::kMaxSlices) > ctr::kSlice ? ctr::cdiv(n, ctr::kMaxSlices)
                                                                  : ctr::kSlice;
    const long long slices = n == 0 ? 1 : ctr::cdiv(n, len);
    out[0] = 0;
    out[1] = slices > 1 ? 2 : 1;
    out[2] = slices;
    out[3] = len;
    out[4] = slices > 1 ? slices * rows * e : 0;
    out[5] = 0;
  } else {
    const long long chunks = ctr::cdiv(n, ctr::kChunk);
    const long long tiles = ctr::cdiv(n, ctr::kSortTile);
    out[0] = 1;
    out[1] = n > 0 ? 3 * ctr::sort_passes(rows) + 2 : 1;
    out[2] = chunks;
    out[3] = 0;
    out[4] = 2 * chunks * e;
    out[5] = 4 * n + ctr::kDigits * (tiles + 1) + 2 * rows;
  }
  return 0;
}

// The shared path: out (rows, E) from the segments; partials holds the
// plan's floats (none for one slice). One or two launches. Returns the
// first cudaError_t.
extern "C" int table_grad_shared(const long long* seg, int segments, float* out,
                                 float* partials, long long n, int rows, int e, void* stream) {
  long long pl[6];
  if (!table_grad_fits(n, rows, e, segments) || table_grad_plan(n, rows, e, pl) || pl[0] != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ctr::Segs s = ctr::make_segs(seg, segments);
  static const cudaError_t set = [] {
    const cudaError_t a = cudaFuncSetAttribute(ctr::slice_sums<1>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(ctr::kSharedBytes));
    return a != cudaSuccess ? a : cudaFuncSetAttribute(
        ctr::slice_sums<4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(ctr::kSharedBytes));
  }();
  if (set != cudaSuccess) return static_cast<int>(set);
  const long long slices = pl[2];
  const bool vec = e % 4 == 0 && ctr::rows_aligned16(s);
  const int units = vec ? e / 4 : e;
  const int groups = units >= ctr::kSliceThreads                  ? 1
                     : ctr::kSliceThreads / units > ctr::kMaxGroups ? ctr::kMaxGroups
                                                                    : ctr::kSliceThreads / units;
  const size_t smem = static_cast<size_t>(rows) * e * sizeof(float);
  float* dst = slices > 1 ? partials : out;
  if (vec)
    ctr::slice_sums<4><<<static_cast<unsigned>(slices), ctr::kSliceThreads, smem, st>>>(
        s, dst, n, rows, units, groups, pl[3]);
  else
    ctr::slice_sums<1><<<static_cast<unsigned>(slices), ctr::kSliceThreads, smem, st>>>(
        s, dst, n, rows, units, groups, pl[3]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return static_cast<int>(err);
  const long long cells = static_cast<long long>(rows) * e;
  const bool vec_out = cells % 4 == 0 && ctr::aligned16(out) && ctr::aligned16(partials);
  const long long cunits = vec_out ? cells / 4 : cells;
  const unsigned blocks = static_cast<unsigned>(ctr::cdiv(cunits, ctr::kReduceThreads));
  if (vec_out)
    ctr::reduce_slices<4><<<blocks, ctr::kReduceThreads, 0, st>>>(partials, out, cunits,
                                                                    static_cast<int>(slices));
  else
    ctr::reduce_slices<1><<<blocks, ctr::kReduceThreads, 0, st>>>(partials, out, cunits,
                                                                    static_cast<int>(slices));
  return static_cast<int>(cudaGetLastError());
}

// The sorted path: out (rows, E) from the segments; partials and ints hold
// the plan's floats and int32 scratch. The key sort, the chunk pass and the
// row pass, 3 x sort_passes + 2 launches (the row pass alone when n == 0).
extern "C" int table_grad_sorted(const long long* seg, int segments, float* out,
                                 float* partials, int* ints, int n, int rows, int e,
                                 void* stream) {
  long long pl[6];
  if (!table_grad_fits(n, rows, e, segments) || table_grad_plan(n, rows, e, pl) || pl[0] != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ctr::Segs s = ctr::make_segs(seg, segments);
  const int chunks = static_cast<int>(pl[2]);
  const int tiles = static_cast<int>(ctr::cdiv(n, ctr::kSortTile));
  int* keys[2] = {ints, ints + n};
  int* vals[2] = {ints + 2LL * n, ints + 3LL * n};
  int* hist = ints + 4LL * n;
  int* tot = hist + static_cast<long long>(ctr::kDigits) * tiles;
  int2* sp = reinterpret_cast<int2*>(tot + ctr::kDigits);
  float* head = partials;
  float* tail = partials + static_cast<long long>(chunks) * e;
  const bool vec = e % 4 == 0 && ctr::rows_aligned16(s) && ctr::aligned16(out) &&
                   ctr::aligned16(head) && ctr::aligned16(tail);
  const int units = vec ? e / 4 : e;
  cudaError_t err;
  int cur = 0;  // the sorted keys and values: keys[cur], vals[cur]
  if (n > 0) {
    const int passes = ctr::sort_passes(rows);
    ctr::make_keys<<<tiles, ctr::kSortThreads, 0, st>>>(s, keys[0], hist, n, rows, tiles);
    for (int pass = 0; pass < passes; ++pass) {
      const int shift = pass * ctr::kDigitBits;
      if (pass > 0)
        ctr::key_hist<<<tiles, ctr::kSortThreads, 0, st>>>(keys[cur], hist, n, shift, tiles);
      ctr::digit_scan<<<ctr::kDigits, ctr::kSortThreads, 0, st>>>(hist, tot, tiles);
      ctr::key_scatter<<<tiles, ctr::kSortThreads, 0, st>>>(
          keys[cur], pass > 0 ? vals[cur] : nullptr, keys[1 - cur], vals[1 - cur], hist, tot, n,
          shift, tiles);
      cur = 1 - cur;
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
    if (vec)
      ctr::chunk_sums<4><<<static_cast<unsigned>(chunks), ctr::kWarps * 32, 0, st>>>(
          s, keys[cur], vals[cur], out, head, tail, sp, n, rows, units);
    else
      ctr::chunk_sums<1><<<static_cast<unsigned>(chunks), ctr::kWarps * 32, 0, st>>>(
          s, keys[cur], vals[cur], out, head, tail, sp, n, rows, units);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  // a chain block a chunk, then the row blocks
  const unsigned blocks = static_cast<unsigned>(
      chunks + ctr::cdiv(rows, ctr::kRowWarps * ctr::kRowsPerWarp));
  if (vec)
    ctr::row_sums<4><<<blocks, ctr::kRowWarps * 32, 0, st>>>(keys[cur], sp, head, tail, out, n,
                                                             rows, units, chunks);
  else
    ctr::row_sums<1><<<blocks, ctr::kRowWarps * 32, 0, st>>>(keys[cur], sp, head, tail, out, n,
                                                             rows, units, chunks);
  return static_cast<int>(cudaGetLastError());
}
