// Merge-sort kernels for NVIDIA Hopper (sm_90a), bound to Python with ctypes.
//
// A key-only sort of 32-bit keys works on the sign-flipped int32 domain:
// the signed order of the words is the keys' unsigned order, and the
// padding sentinel is INT32_MAX.  The array is a power-of-two number of
// 16384-element tiles, and the sort is
//
//   tile_sort     one launch: each tile sorted by one CTA, first in
//                 registers by a fixed network, then by merge-path rounds
//                 in shared memory
//   merge_level   one launch a level: runs of 2^level tiles merged
//                 pairwise by persistent CTAs that find their own splits;
//                 output tile t is the merge of a window of run A and a
//                 window of run B whose lengths add up to one tile
//
// Both kernels merge with merge_path(): a thread finds where its run of
// outputs starts by a merge-path search in shared memory and merges that
// run into registers.  Every C entry point takes device pointers and the
// CUDA stream as opaque pointers, launches on that stream, never
// synchronises, allocates nothing, and returns cudaGetLastError() (or
// cudaErrorInvalidValue / cudaErrorMisalignedAddress for arguments it does
// not take) so the Python wrapper can raise.  Element counts stay below
// 2^31 (the split offsets are int32); the wrappers check that.  Both
// kernels use more than the 48 KB of static shared memory, so each launch
// first raises the kernel's dynamic limit with cudaFuncSetAttribute.
//
// Shared-memory tiles that threads write by runs are skewed by one word
// every 32 (pad()): a warp whose lanes touch words i * K + j, K a multiple
// of 16 up to 32, hits 32 different banks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16384;

// tile_sort: threads x keys a thread.  512 x 32 takes 64 registers a
// thread, so two CTAs share an SM (1024 x 16: 60 registers, one CTA; 256 x
// 64: 80 registers and 2-way bank conflicts in its 64-key runs), and was
// the fastest of the three on an H100 (PERF.md; scripts/merge_variants.py
// times the others).
constexpr int kSortThreads = 512;
constexpr int kSortItems = kTile / kSortThreads;

// merge_level: merging threads x outputs a thread, and the number of
// window buffers a CTA cycles through, each filled by its own producer warp.
constexpr int kMergeThreads = 512;
constexpr int kMergeItems = kTile / kMergeThreads;
constexpr int kMergeBuffers = 2;
constexpr int kMergeBlock = kMergeThreads + 32 * kMergeBuffers;

// A skewed tile, one slack word for the merge's read past a run's end, and
// a multiple of 4 words so that every buffer starts 16-byte aligned.
constexpr int kBufWords = (kTile + kTile / 32 + 1 + 3) & ~3;
constexpr int kSortSmemBytes = kBufWords * 4;
// A window buffer: the covers of a tile's two windows, each at most 6
// words longer than its window.
constexpr int kLandWords = kTile + 16;
constexpr int kMergeSmemBytes = (kMergeBuffers * kLandWords + kBufWords) * 4;

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// Sorts v ascending with a bitonic network.  Fully unrolled, so every
// compare-exchange direction is a compile-time constant and each is one
// min and one max.
template <int K>
__device__ __forceinline__ void sort_registers(int32_t (&v)[K]) {
#pragma unroll
  for (int lk = 1; (1 << lk) <= K; ++lk) {
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) {
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int l = i ^ (1 << lj);
        if (l > i) {
          const int32_t lo = min(v[i], v[l]);
          const int32_t hi = max(v[i], v[l]);
          const bool asc = (i & (1 << lk)) == 0;
          v[i] = asc ? lo : hi;
          v[l] = asc ? hi : lo;
        }
      }
    }
  }
}

// Outputs [d, d + K) of the merge of sorted A = s[a0, a0 + na) and
// B = s[b0, b0 + nb) (indices before pad()), into v.  The
// merge-path search finds how many of the first d outputs come from A, ties
// taking from A; then K steps of a serial merge keep both heads in
// registers.  Reads at most one word past the end of A and of B, which the
// callers keep inside their buffers; d + K <= na + nb.
template <int K>
__device__ __forceinline__ void merge_path(const int32_t* s, int a0, int na,
                                           int b0, int nb, int d,
                                           int32_t (&v)[K]) {
  int lo = d > nb ? d - nb : 0;
  int hi = d < na ? d : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[pad(a0 + mid)] <= s[pad(b0 + d - mid - 1)])
      lo = mid + 1;
    else
      hi = mid;
  }
  int ai = a0 + lo;
  int bi = b0 + d - lo;
  const int ae = a0 + na;
  const int be = b0 + nb;
  int32_t ka = s[pad(ai)];
  int32_t kb = s[pad(bi)];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const bool take_a = bi >= be || (ai < ae && ka <= kb);
    v[j] = take_a ? ka : kb;
    if (take_a)
      ka = s[pad(++ai)];
    else
      kb = s[pad(++bi)];
  }
}

// ------------------------------------------------------------ tile_sort
//
// Replaces radix_sort_tpu/ops/pallas_merge.py:tile_sort (_tile_sort_kernel,
// _bitonic_sort), whose bitonic network ran on (128, 128) vregs with
// roll-based partners.  Bound on this card by shared memory, not bytes:
// the tile is read and written to device memory once (8 bytes a key, 0.08
// ms at 2^25), but it has to be sorted on chip.  A bitonic network does
// O(n log^2 n) compare-exchanges, and at 1024 threads x 16 keys 55 of its
// 105 stages go through shared memory with a barrier each (~8.5 MB of
// shared-memory traffic a tile).  Here one CTA of kSortThreads threads
// sorts one tile in O(n log n) work:
//   - a coalesced load into shared memory, and each thread takes its
//     kSortItems consecutive keys into registers (the one transpose);
//   - sort_registers(): a network with compile-time directions;
//   - log2(kSortThreads) merge rounds: the runs go back to shared memory,
//     and each thread merges its kSortItems outputs of the pair of runs it
//     falls in with merge_path();
//   - back through shared memory for a coalesced store.
// Shared-memory traffic a tile: the two transposes, a store and ~one read
// a key a round, and the searches, ~1.8 MB; at 2^25 a floor of ~0.11 ms at
// the card's ~33 TB/s of shared-memory bandwidth (132 SMs x 128 B a
// clock), beside the 0.08 ms HBM bound.
__global__ void __launch_bounds__(kSortThreads)
tile_sort_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ y) {
  extern __shared__ __align__(16) int32_t s[];
  constexpr int K = kSortItems;
  const int tid = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * kTile;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int i = r * kSortThreads + tid;
    s[pad(i)] = x[base + i];
  }
  __syncthreads();
  const int first = tid * K;
  int32_t v[K];
#pragma unroll
  for (int j = 0; j < K; ++j) v[j] = s[pad(first + j)];
  sort_registers(v);
  for (int w = K; w < kTile; w <<= 1) {  // sorted runs of w -> of 2w
    __syncthreads();                     // every read of s is done
#pragma unroll
    for (int j = 0; j < K; ++j) s[pad(first + j)] = v[j];
    __syncthreads();
    const int pair = first & ~(2 * w - 1);
    merge_path<K>(s, pair, w, pair + w, w, first - pair, v);
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < K; ++j) s[pad(first + j)] = v[j];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int i = r * kSortThreads + tid;
    y[base + i] = s[pad(i)];
  }
}

// ---------------------------------------------------------- merge_level
//
// Replaces radix_sort_tpu/ops/pallas_merge.py:merge_level (_merge_kernel)
// and the XLA merge-path search of _merge_splits / _level_splits before it.
// The TPU kernel DMA'd row-aligned windows, rotated them to element offsets,
// masked the tails with the sentinel, flipped B and ran a bitonic halver and
// merge.  Bound by bytes on this card: each level reads and writes the
// whole array once (8 bytes a key).  A CTA a tile that loads, searches,
// merges and stores in strict phases after a separate split launch leaves
// each phase's latency exposed (0.47 of the bound).  Here one launch a level
// of persistent CTAs (as many as fit on the card, at most one a tile)
// each walks a contiguous run of output tiles, and the phases of
// consecutive tiles overlap:
//   - kMergeBuffers producer warps, one a window buffer: warp b takes tiles
//     b, b + kMergeBuffers, ... of its CTA's run, finds the tile's splits
//     with diagonal_splits() (writing ia/ib/la), bounded by the end split
//     of its own previous tile, waits until its buffer is free and copies
//     both windows into it with Hopper's 1-D bulk copy, whose bytes
//     complete the buffer's "full" mbarrier.  So the next tile's search
//     and load run while the current tile merges.
//   - kMergeThreads merging threads: wait for the tile's window buffer,
//     copy both windows into one skewed work tile (pad()) and free the
//     buffer by its "empty" mbarrier, merge kMergeItems outputs each from
//     the work tile with merge_path(), put the merged tile back into it,
//     and store it to device memory with 16-byte coalesced stores.
// Merging from the skewed copy keeps the merge's reads off one bank: a
// thread's outputs start 32 apart, so where one window supplies a whole
// tile (Range keys, disjoint runs) merging straight from the unskewed
// window buffer took 1.5x as long.  Contiguous runs keep each search to 3
// rounds at every level (a grid stride was faster at level 0 and slower
// from about level 7 on), and the merged tile leaves through shared
// memory because 16-byte stores straight from registers, 128 bytes apart
// a lane, took 2.6x as long.  A level runs at ~0.8 of a device-to-device
// copy's rate on an H100 (PERF.md).
// A bulk copy moves 16-byte aligned runs, so a window [i, i + len) is
// copied as its cover [i & ~3, (i + len + 3) & ~3), which never passes n
// (a multiple of 16384), and the head offset i & 3 goes into the indexing;
// an empty window is not copied.  x must be 16-byte aligned.
//
// The split predicate is _merge_splits' (pallas_merge.py:216-224): "the
// split m is too small" iff m < R, j = g - m - 1 >= 0, and (j >= R or
// A[m] <= B[j]); ties take from A.  It is false for every m >= the split
// and true below.  The diagonal after the last tile of a pair is 2R, whose
// split is R: that tile takes whatever is left of A.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Returns once the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Copies `bytes` (a multiple of 16) from 16-byte aligned global memory to
// 16-byte aligned shared memory; the bytes count against bar's expect_tx.
__device__ __forceinline__ void bulk_load(int32_t* dst, const int32_t* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Barrier of the merging threads only (the producer warps run on).
__device__ __forceinline__ void merge_threads_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kMergeThreads) : "memory");
}

// The splits at diagonals g and g + kTile of the pair of runs A = x[base,
// base + run) and B = x[base + run, base + 2 run), found by one warp with
// two interleaved 32-way searches in device memory: each round the 32
// lanes probe 32 points of each range at once, and both searches share the
// rounds' latency.  A split known at an earlier diagonal of the same pair
// (g_known >= 0, split a_known) bounds the range: the split at gh lies in
// [a_known, a_known + gh - g_known]: with the split kMergeBuffers tiles
// back, each search takes 3 rounds of dependent loads at any level (a
// whole run of 2^26 keys: 6).
__device__ void diagonal_splits(const int32_t* __restrict__ x, int64_t base,
                                int64_t run, int64_t g, int64_t g_known,
                                int64_t a_known, int lane, int64_t& split0,
                                int64_t& split1) {
  int64_t lo[2], hi[2], gh[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    gh[h] = g + h * kTile;
    lo[h] = gh[h] > run ? gh[h] - run : 0;
    hi[h] = gh[h] < run ? gh[h] : run;  // the predicate is false at hi
    if (g_known >= 0) {
      lo[h] = max(lo[h], a_known);
      hi[h] = min(hi[h], a_known + gh[h] - g_known);
    }
  }
  while (lo[0] < hi[0] || lo[1] < hi[1]) {  // uniform across the warp
    bool too_small[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t len = hi[h] - lo[h];
      const int64_t m = lo[h] + len * lane / 32;
      const int64_t j = gh[h] - m - 1;
      too_small[h] = false;
      if (len > 0 && m < run && j >= 0)
        too_small[h] = j >= run || x[base + m] <= x[base + run + j];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = __popc(__ballot_sync(0xFFFFFFFFu, too_small[h]));
      const int64_t len = hi[h] - lo[h];
      if (len == 0) continue;
      if (c == 0) {
        hi[h] = lo[h];
      } else {
        const int64_t next_lo = lo[h] + len * (c - 1) / 32 + 1;
        if (c < 32) hi[h] = lo[h] + len * c / 32;
        lo[h] = next_lo;
      }
    }
  }
  split0 = lo[0];
  split1 = lo[1];
}

__global__ void __launch_bounds__(kMergeBlock, 1)
merge_level_kernel(const int32_t* __restrict__ x, int64_t num_tiles,
                   int level, int32_t* __restrict__ ia,
                   int32_t* __restrict__ ib, int32_t* __restrict__ la,
                   int32_t* __restrict__ y) {
  extern __shared__ __align__(16) int32_t s[];
  __shared__ __align__(8) uint64_t full[kMergeBuffers];
  __shared__ __align__(8) uint64_t empty[kMergeBuffers];
  __shared__ int4 meta[kMergeBuffers];  // A's start, A's length, B's start
  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int b = 0; b < kMergeBuffers; ++b) {
      mbar_init(&full[b], 1);
      mbar_init(&empty[b], kMergeThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // this CTA's tiles, first + k for k < count: a contiguous run, the first
  // num_tiles % gridDim.x CTAs one tile longer
  const int64_t q = num_tiles / gridDim.x;
  const int64_t rem = num_tiles % gridDim.x;
  const int64_t first = blockIdx.x * q + min((int64_t)blockIdx.x, rem);
  const int64_t count = q + (blockIdx.x < rem);

  if (tid >= kMergeThreads) {  // producer warp b fills buffer b
    const int b = (tid - kMergeThreads) >> 5;
    const int lane = tid & 31;
    const int64_t run = (int64_t)kTile << level;
    const int64_t per_pair = 2LL << level;
    int32_t* buf = s + b * kLandWords;  // this warp's window buffer
    // the end split of this warp's last tile, and its pair
    int64_t g_known = -1, a_known = 0, pair_known = -1;
    for (int64_t k = b, use = 0; k < count; k += kMergeBuffers, ++use) {
      const int64_t t = first + k;
      const int64_t in_pair = t % per_pair;
      const int64_t base = t / per_pair * 2 * run;
      const int64_t g = in_pair * kTile;
      if (t / per_pair != pair_known) g_known = -1;
      int64_t a, a_next;
      diagonal_splits(x, base, run, g, g_known, a_known, lane, a, a_next);
      g_known = g + kTile;
      a_known = a_next;
      pair_known = t / per_pair;
      if (lane == 0) {
        const int64_t ga = base + a;
        const int64_t gb = base + run + g - a;
        const int na = (int)(a_next - a);
        const int nb = kTile - na;
        ia[t] = (int32_t)ga;
        ib[t] = (int32_t)gb;
        la[t] = na;
        const int64_t a_lo = ga & ~3LL;
        const int64_t b_lo = gb & ~3LL;
        const int a_words = na ? (int)(((ga + na + 3) & ~3LL) - a_lo) : 0;
        const int b_words = nb ? (int)(((gb + nb + 3) & ~3LL) - b_lo) : 0;
        if (use > 0) mbar_wait(&empty[b], (uint32_t)(use - 1) & 1);
        meta[b] = make_int4(na ? (int)(ga - a_lo) : 0, na,
                            a_words + (int)(gb - b_lo), 0);
        mbar_arrive_expect_tx(&full[b], (uint32_t)(a_words + b_words) * 4);
        if (a_words) bulk_load(buf, x + a_lo, a_words * 4, &full[b]);
        if (b_words) bulk_load(buf + a_words, x + b_lo, b_words * 4, &full[b]);
      }
      __syncwarp();
    }
    return;
  }

  constexpr int K = kMergeItems;
  int32_t* work = s + kMergeBuffers * kLandWords;  // the tile, skewed
  const int d = tid * K;
  for (int64_t k = 0; k < count; ++k) {
    const int64_t t = first + k;
    const int b = (int)(k % kMergeBuffers);
    const int32_t* land = s + b * kLandWords;
    mbar_wait(&full[b], (uint32_t)(k / kMergeBuffers) & 1);
    const int4 m = meta[b];
    const int na = m.y;
    merge_threads_sync();  // the last tile's store has read work
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int i = r * kMergeThreads + tid;
      work[pad(i)] = i < na ? land[m.x + i] : land[m.z + i - na];
    }
    mbar_arrive(&empty[b]);  // the producer may refill the window buffer
    merge_threads_sync();
    int32_t v[K];
    merge_path<K>(work, 0, na, na, kTile - na, d, v);
    merge_threads_sync();  // every read of the windows is done
#pragma unroll
    for (int j = 0; j < K; ++j) work[pad(d + j)] = v[j];
    merge_threads_sync();
    int4* out = reinterpret_cast<int4*>(y + t * kTile);
#pragma unroll
    for (int r = 0; r < kTile / 4 / kMergeThreads; ++r) {
      const int q = r * kMergeThreads + tid;
      out[q] = make_int4(work[pad(4 * q)], work[pad(4 * q + 1)],
                         work[pad(4 * q + 2)], work[pad(4 * q + 3)]);
    }
  }
}

// CTAs of merge_level_kernel that fit on the current device at once.
cudaError_t merge_grid(long long* ctas) {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && cached[dev]) {
    *ctas = cached[dev];
    return cudaSuccess;
  }
  e = cudaFuncSetAttribute(merge_level_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMergeSmemBytes);
  if (e != cudaSuccess) return e;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, merge_level_kernel, kMergeBlock, kMergeSmemBytes);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if (dev < 64) cached[dev] = sms * per_sm;
  *ctas = (long long)sms * per_sm;
  return cudaSuccess;
}

}  // namespace

extern "C" {

int rst_merge_tile() { return kTile; }

// x, y: n int32 each, n a positive multiple of rst_merge_tile().
int rst_tile_sort(const void* x, long long n, void* y, void* stream) {
  if (n <= 0 || n % kTile != 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      tile_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSortSmemBytes);
  if (e != cudaSuccess) return (int)e;
  tile_sort_kernel<<<(unsigned)(n / kTile), kSortThreads, kSortSmemBytes,
                     (cudaStream_t)stream>>>((const int32_t*)x, (int32_t*)y);
  return (int)cudaGetLastError();
}

// One merge level.  x, y: n int32 each, 16-byte aligned (y must not alias
// x), runs of 2^level tiles sorted in x, n / rst_merge_tile() a multiple of
// 2^(level+1).  ia, ib, la: n / rst_merge_tile() int32 each, written with
// the splits the merge used.
int rst_merge_level(const void* x, long long n, int level, void* ia,
                    void* ib, void* la, void* y, void* stream) {
  if (n <= 0 || n % kTile != 0 || level < 0 || level > 30)
    return (int)cudaErrorInvalidValue;
  const long long num_tiles = n / kTile;
  if (num_tiles % (2LL << level) != 0) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)x % 16 != 0 || (uintptr_t)y % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  long long ctas = 0;
  cudaError_t e = merge_grid(&ctas);
  if (e != cudaSuccess) return (int)e;
  const long long grid = num_tiles < ctas ? num_tiles : ctas;
  merge_level_kernel<<<(unsigned)grid, kMergeBlock, kMergeSmemBytes,
                       (cudaStream_t)stream>>>(
      (const int32_t*)x, num_tiles, level, (int32_t*)ia, (int32_t*)ib,
      (int32_t*)la, (int32_t*)y);
  return (int)cudaGetLastError();
}

}  // extern "C"
