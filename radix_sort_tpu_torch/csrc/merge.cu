// Merge-sort kernels for NVIDIA Hopper (sm_90a), bound to Python with ctypes.
//
// A key-only sort of 32-bit keys works on the sign-flipped int32 domain:
// the signed order of the words is the keys' unsigned order, and the
// padding sentinel is INT32_MAX.  The array is a power-of-two number of
// 16384-element tiles, and the sort is
//
//   tile_sort     one launch: each tile sorted in shared memory
//   merge_level   one call per level: runs of 2^level tiles merged pairwise;
//                 output tile t is the merge of a window of run A and a
//                 window of run B whose lengths add up to one tile
//
// Every C entry point takes device pointers and the CUDA stream as opaque
// pointers, launches on that stream, never synchronises, allocates nothing,
// and returns cudaGetLastError() so the Python wrapper can raise.  Element
// counts stay below 2^31 (the split offsets are int32); the wrappers check
// that.  Both kernels keep a tile in 66 KB of dynamic shared memory, above
// the 48 KB static limit, so each launch first raises the kernel's limit
// with cudaFuncSetAttribute.
//
// Shared-memory words are skewed by one every 32 (pad()), so a warp whose
// lanes read 16 consecutive words each hits 32 different banks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16384;
constexpr int kThreads = 1024;
constexpr int kItems = kTile / kThreads;  // 16 consecutive keys a thread
constexpr int kSmemBytes = (kTile + kTile / 32) * 4;
constexpr int kSplitThreads = 256;

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

__device__ __forceinline__ void load_run(const int32_t* s, int first,
                                         int32_t (&v)[kItems]) {
#pragma unroll
  for (int j = 0; j < kItems; ++j) v[j] = s[pad(first + j)];
}

__device__ __forceinline__ void store_run(int32_t* s, int first,
                                          const int32_t (&v)[kItems]) {
#pragma unroll
  for (int j = 0; j < kItems; ++j) s[pad(first + j)] = v[j];
}

// Compare-exchange of element i with i + D (i & D == 0) inside one thread's
// run; the block of k elements that holds i sorts ascending iff i & k == 0.
template <int D>
__device__ __forceinline__ void register_stage(int32_t (&v)[kItems],
                                               int first, int k) {
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if ((j & D) == 0) {
      const bool asc = ((first + j) & k) == 0;
      const int32_t lo = min(v[j], v[j + D]);
      const int32_t hi = max(v[j], v[j + D]);
      v[j] = asc ? lo : hi;
      v[j + D] = asc ? hi : lo;
    }
  }
}

// The stages of distance min(k / 2, kItems / 2) down to 1.
__device__ __forceinline__ void register_stages(int32_t (&v)[kItems],
                                                int first, int k) {
  if (k >= 16) register_stage<8>(v, first, k);
  if (k >= 8) register_stage<4>(v, first, k);
  if (k >= 4) register_stage<2>(v, first, k);
  register_stage<1>(v, first, k);
}

// One compare-exchange stage of distance d >= kItems over the whole tile:
// thread tid takes pairs tid, tid + kThreads, ...; pair p is element i (p
// with a zero bit inserted at log2(d)) and i + d.
__device__ __forceinline__ void shared_stage(int32_t* s, int d, int k,
                                             int tid) {
#pragma unroll
  for (int r = 0; r < kTile / 2 / kThreads; ++r) {
    const int p = r * kThreads + tid;
    const int i = ((p & ~(d - 1)) << 1) | (p & (d - 1));
    const bool asc = (i & k) == 0;
    const int32_t a = s[pad(i)];
    const int32_t b = s[pad(i + d)];
    s[pad(i)] = asc ? min(a, b) : max(a, b);
    s[pad(i + d)] = asc ? max(a, b) : min(a, b);
  }
}

// ------------------------------------------------------------ tile_sort
//
// Replaces radix_sort_tpu/ops/pallas_merge.py:tile_sort (_tile_sort_kernel),
// whose bitonic network ran on (128, 128) vregs with roll-based partners.
// Here one CTA of 1024 threads sorts one tile with the same network: each
// thread holds 16 consecutive keys in registers, so the 4 stages of every
// block size with partners closer than 16 run in registers (all stages of
// block sizes 2..16 included), and only the stages of distance >= 16 go
// through shared memory, one barrier each (55 of the 105 stages).  Bound by
// the shared-memory stages, not by bytes: the tile is read and written to
// device memory once (8 bytes a key).
__global__ void __launch_bounds__(kThreads)
tile_sort_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ y) {
  extern __shared__ int32_t s[];
  const int tid = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * kTile;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int i = r * kThreads + tid;
    s[pad(i)] = x[base + i];
  }
  __syncthreads();
  const int first = tid * kItems;
  int32_t v[kItems];
  load_run(s, first, v);
  for (int k = 2; k <= kTile; k <<= 1) {
    if (k > kItems) {
      store_run(s, first, v);
      __syncthreads();
      for (int d = k >> 1; d >= kItems; d >>= 1) {
        shared_stage(s, d, k, tid);
        __syncthreads();
      }
      load_run(s, first, v);
    }
    register_stages(v, first, k);
  }
  store_run(s, first, v);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int i = r * kThreads + tid;
    y[base + i] = s[pad(i)];
  }
}

// ---------------------------------------------------------- merge_level
//
// Replaces radix_sort_tpu/ops/pallas_merge.py:merge_level (_merge_kernel)
// and the XLA merge-path search of _merge_splits / _level_splits before it.
// The TPU kernel DMA'd row-aligned windows, rotated them to element offsets,
// masked the tails with the sentinel, flipped B and ran a bitonic halver and
// merge.  None of that is needed here: windows are read at any offset, and
// a merge path splits the work.  Bound by bytes: each level reads and writes
// the whole array once (8 bytes a key).
//
// merge_splits_kernel: one warp per output tile t finds its diagonal split
// (how many of the tile's first output elements come from run A) and the
// next tile's, with a 32-way search in device memory: each round the 32
// lanes probe 32 points of the range at once, so a run of 2^26 keys takes 6
// rounds of dependent loads instead of 28.  It runs as its own small launch
// so no CTA of the merge waits on those loads before streaming its tile.
//
// The predicate is _merge_splits' (pallas_merge.py:216-224): "the split m
// is too small" iff m < R, j = g - m - 1 >= 0, and (j >= R or A[m] <= B[j]);
// ties take from A.  It is false for every m >= the split and true below.
__device__ int64_t diagonal_split(const int32_t* __restrict__ x,
                                  int64_t base, int64_t run, int64_t g,
                                  int lane) {
  int64_t lo = g > run ? g - run : 0;
  int64_t hi = g < run ? g : run;  // the predicate is false at hi
  while (lo < hi) {                // uniform across the warp
    const int64_t len = hi - lo;
    const int64_t m = lo + len * lane / 32;
    const int64_t j = g - m - 1;
    bool too_small = false;
    if (m < run && j >= 0)
      too_small = j >= run || x[base + m] <= x[base + run + j];
    const int c = __popc(__ballot_sync(0xFFFFFFFFu, too_small));
    if (c == 0) {
      hi = lo;
    } else {
      const int64_t next_lo = lo + len * (c - 1) / 32 + 1;
      if (c < 32) hi = lo + len * c / 32;
      lo = next_lo;
    }
  }
  return lo;
}

__global__ void merge_splits_kernel(const int32_t* __restrict__ x,
                                    int64_t num_tiles, int level,
                                    int32_t* __restrict__ ia,
                                    int32_t* __restrict__ ib,
                                    int32_t* __restrict__ la) {
  const int64_t t = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (t >= num_tiles) return;  // whole warps only
  const int64_t run = (int64_t)kTile << level;
  const int64_t per_pair = 2LL << level;
  const int64_t in_pair = t % per_pair;
  const int64_t base = t / per_pair * 2 * run;
  const int64_t g = in_pair * kTile;
  const int64_t a = diagonal_split(x, base, run, g, lane);
  // the last tile of a pair takes whatever is left of A
  const int64_t a_next = in_pair == per_pair - 1
                             ? run
                             : diagonal_split(x, base, run, g + kTile, lane);
  if (lane == 0) {
    ia[t] = (int32_t)(base + a);
    ib[t] = (int32_t)(base + run + g - a);
    la[t] = (int32_t)(a_next - a);
  }
}

// One CTA per output tile: A's window [ia, ia + la) and B's [ib, ib + lb),
// lb = kTile - la, go side by side into one shared buffer; each thread
// merge-path-searches the start of its 16 outputs there, merges them into
// registers, and the tile leaves through shared memory so the writes
// coalesce.
__global__ void __launch_bounds__(kThreads)
merge_level_kernel(const int32_t* __restrict__ x,
                   const int32_t* __restrict__ ia,
                   const int32_t* __restrict__ ib,
                   const int32_t* __restrict__ la, int32_t* __restrict__ y) {
  extern __shared__ int32_t s[];
  const int tid = threadIdx.x;
  const int t = blockIdx.x;
  const int64_t a0 = ia[t];
  const int64_t b0 = ib[t];
  const int na = la[t];
  const int nb = kTile - na;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int i = r * kThreads + tid;
    s[pad(i)] = i < na ? x[a0 + i] : x[b0 + (i - na)];
  }
  __syncthreads();
  const int d = tid * kItems;
  int lo = d > nb ? d - nb : 0;
  int hi = d < na ? d : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[pad(mid)] <= s[pad(na + d - mid - 1)])
      lo = mid + 1;
    else
      hi = mid;
  }
  int ai = lo;
  int bi = d - lo;
  int32_t v[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool take_a =
        ai < na && (bi >= nb || s[pad(ai)] <= s[pad(na + bi)]);
    v[j] = take_a ? s[pad(ai++)] : s[pad(na + bi++)];
  }
  __syncthreads();
  store_run(s, d, v);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int i = r * kThreads + tid;
    y[(int64_t)t * kTile + i] = s[pad(i)];
  }
}

}  // namespace

extern "C" {

int rst_merge_tile() { return kTile; }

// x, y: n int32 each, n a positive multiple of rst_merge_tile().
int rst_tile_sort(const void* x, long long n, void* y, void* stream) {
  if (n <= 0 || n % kTile != 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      tile_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  tile_sort_kernel<<<(unsigned)(n / kTile), kThreads, kSmemBytes,
                     (cudaStream_t)stream>>>((const int32_t*)x, (int32_t*)y);
  return (int)cudaGetLastError();
}

// One merge level.  x, y: n int32 each (y must not alias x), runs of
// 2^level tiles sorted in x, n / rst_merge_tile() a multiple of 2^(level+1).
// ia, ib, la: n / rst_merge_tile() int32 each, written with the splits the
// merge used.
int rst_merge_level(const void* x, long long n, int level, void* ia,
                    void* ib, void* la, void* y, void* stream) {
  if (n <= 0 || n % kTile != 0 || level < 0 || level > 30)
    return (int)cudaErrorInvalidValue;
  const long long num_tiles = n / kTile;
  if (num_tiles % (2LL << level) != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long split_blocks =
      (num_tiles * 32 + kSplitThreads - 1) / kSplitThreads;
  merge_splits_kernel<<<(unsigned)split_blocks, kSplitThreads, 0, s>>>(
      (const int32_t*)x, num_tiles, level, (int32_t*)ia, (int32_t*)ib,
      (int32_t*)la);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(merge_level_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  merge_level_kernel<<<(unsigned)num_tiles, kThreads, kSmemBytes, s>>>(
      (const int32_t*)x, (const int32_t*)ia, (const int32_t*)ib,
      (const int32_t*)la, (int32_t*)y);
  return (int)cudaGetLastError();
}

}  // extern "C"
