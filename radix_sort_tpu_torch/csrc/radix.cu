// Radix-pass kernels for NVIDIA Hopper (sm_90a), bound to Python with ctypes.
//
// A sort (or a partition) is a onesweep LSD radix sort over int32 planes
// (and 8-byte payload planes, moved at their own width: see rank_scatter):
//
//   pass_histograms  the digit counts of every pass, (P, R), from one read
//                    of each key word plane
//   rank_scatter     one launch a pass in look-back mode: each tile ranks
//                    its elements, finds its global digit offsets by
//                    decoupled look-back over the tiles before it, and
//                    scatters the digit plane and every payload plane
//                    through a shared-memory staging tile.  Every CTA
//                    derives the sort's plan from the (P, R) table first
//                    (Plan): a pass that one digit fills returns at once,
//                    so the host launches every pass and reads nothing
//
// rank_scatter, the pass kernel, is in radix_pass.cuh; its instances with an
// 8-byte plane are built in radix_wide.cu.
//
// The three-launch pass of the JAX package's contract stays for rank_pass
// and the harness's per-phase timings:
//
//   digit_histogram  per-tile digit counts, written digit-major (R, B)
//   exclusive_scan   exclusive prefix sum of the flat (R * B) counts; the
//                    digit-major order is what makes the scatter stable
//                    (one single-pass launch after a memset of its scratch)
//   rank_scatter     in base-table mode: the scanned counts give each
//                    tile's offsets
//
// A sort or partition on the card is one call, rst_sort_planes: it enqueues
// the memset of its workspace, the pass_histograms launch and every pass's
// launches.  The entries of each kernel (rst_pass_histograms,
// rst_onesweep_pass, rst_rank_scatter, ...) stay for the per-kernel checks
// and the three-launch pass.
//
// Every C entry point takes device pointers and the CUDA stream as opaque
// pointers, launches on that stream, never synchronises, allocates nothing,
// and returns cudaGetLastError() so the Python wrapper can raise.
//
// Tiles are masked at the ragged end inside the kernels: no input is padded.
// Element counts must stay below 2^31 (destinations are int32); the wrappers
// check that.
//
// The key plane of pass_histograms and rank_scatter (the digit source) is an
// int32 word plane, whose digit is taken from its bits as they are, or the
// caller's own 1- or 2-byte keys.  A narrow key's digit is taken from its
// sortable image, computed in registers (KeyKind), and the pass moves the
// caller's bits, so no widened or transformed key plane is ever written.
// A payload plane is int32 or 8 bytes an element (an int64, uint64 or
// float64 column as it is): the bits move, never values.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "radix_pass.cuh"

namespace {

using namespace rst;

// kind: 0 unsigned, 1 signed, 2 float; an int32 word plane is unsigned.
bool key_kind(int key_bytes, int kind, KeyKind* kk) {
  if (key_bytes == 4) {
    *kk = {0u, 0u};
    return kind == 0;
  }
  if (key_bytes != 1 && key_bytes != 2) return false;
  const unsigned sign = 1u << (8 * key_bytes - 1);
  switch (kind) {
    case 0:
      *kk = {0u, 0u};
      return true;
    case 1:
      *kk = {sign, sign};
      return true;
    case 2:
      *kk = {sign, 2u * sign - 1u};
      return true;
  }
  return false;
}

// ------------------------------------------------------------ histogram
//
// Replaces radix_sort_tpu/ops/pallas_radix.py:digit_histogram
// (_hist_kernel_narrow / _hist_kernel_wide).  Bound by reading the plane
// once (4 bytes an element); the TPU version needed a separate XLA pass to
// extract digits first, here the digit is extracted in the kernel.  Each
// warp counts into its own shared-memory sub-histogram, which keeps the
// shared-memory atomics of one warp off the others' counters.
template <int THREADS>
__global__ void digit_histogram_kernel(const int32_t* __restrict__ x,
                                       int64_t n, int tile, int shift,
                                       int radix, int32_t* __restrict__ out,
                                       int64_t stride_b, int64_t stride_d) {
  constexpr int kWarps = THREADS / 32;
  __shared__ int hist[kWarps * kMaxRadix];
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kWarps * radix; i += THREADS) hist[i] = 0;
  __syncthreads();
  const int64_t start = (int64_t)blockIdx.x * tile;
  const int64_t end = start + tile < n ? start + tile : n;
  const unsigned mask = (unsigned)radix - 1u;
  int* h = hist + warp * radix;
  for (int64_t i = start + threadIdx.x; i < end; i += THREADS) {
    const unsigned d = ((unsigned)x[i] >> shift) & mask;
    atomicAdd(&h[d], 1);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < radix; d += THREADS) {
    int c = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) c += hist[w * radix + d];
    out[(int64_t)blockIdx.x * stride_b + (int64_t)d * stride_d] = c;
  }
}

// ----------------------------------------------------------------- scan
//
// Replaces radix_sort_tpu/ops/pallas_radix.py:217 exclusive_scan
// (_scan_kernel).  The TPU kernel carried a running sum across a
// sequential grid; CTAs run in no order here, so one launch scans the
// input in a single pass with decoupled look-back (Merrill & Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", NVIDIA
// 2016).
//
// Bound by bytes: every element is read once and written once, 8 bytes an
// element (64 MB at 2^23, the digit-major (R * B) histogram of a 2^27
// sort), where the three launches it replaces moved 96 MB.  What the
// design does about that bound:
//
//   - One CTA a tile of 8192 elements (32 KB), and its tile id comes from
//     a global counter in the order CTAs start, not from blockIdx: every
//     tile it waits for belongs to a CTA that is already running, so the
//     single pass always makes progress.
//   - The tile arrives in shared memory by 16-byte cp.async copies,
//     striped over the CTA so a warp reads 512 consecutive bytes, and
//     leaves the same way after the scan.  The chunks are XOR-swizzled, so
//     the striped copies and each thread's reads of its own 32 consecutive
//     elements are both free of bank conflicts.  Four CTAs an SM keep
//     128 KB of loads in flight while others scan and look back.
//   - Each tile publishes its aggregate as soon as it is summed, then one
//     warp reads the status words of 32 predecessors a step until it meets
//     an inclusive prefix, and publishes its own.  A status word is 64
//     bits, {flag, value}, stored with release and loaded with acquire at
//     device scope, so a flag is never seen without its value.
//
// Alternatives measured on an H100 80GB HBM3 at 700 W (PERF.md keeps the
// numbers): persistent CTAs with a two-stage copy ring were about 4x
// slower, because a tile whose id a CTA holds ahead publishes nothing
// until that CTA reaches it, so every later tile spins behind it;
// 4096-element tiles were 12% slower; reading 128 or 256 predecessors a
// step, relaxed loads, and a backoff in the spin gained nothing or lost.
//
// Tiles are cut from the 16-byte boundary at or below x, so a view that
// starts mid-vector (x[1:]) still loads whole tiles with 16-byte copies:
// its first `lead` elements belong to tile 0, which, like the ragged last
// tile, loads and stores element by element.  Values are unsigned, so the
// sums wrap exactly like an int32 cumsum.
constexpr int kScanThreads = 256;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kScanItems = 32;  // consecutive elements a thread
constexpr int kScanChunks = kScanItems / 4;  // 16-byte chunks a thread
constexpr int kScanTile = kScanThreads * kScanItems;  // 8192 int32, 32 KB
constexpr int kScanVecs = kScanTile / 4;              // 16-byte chunks

// Chunk c of a tile lives at scan_swizzle(c): eight threads reading their
// own chunk k (blocked) or eight consecutive chunks (striped) hit eight
// different 16-byte bank groups.
__device__ __forceinline__ int scan_swizzle(int c) {
  return c ^ ((c >> 3) & (kScanChunks - 1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

// Run by all 32 lanes of one warp.  Publishes tile t's aggregate, sums the
// predecessors' status words back to the nearest inclusive prefix, then
// publishes t's inclusive prefix.  Returns t's exclusive prefix.
__device__ unsigned scan_look_back(unsigned long long* status, int t,
                                   unsigned aggregate, int lane) {
  if (t == 0) {
    if (lane == 0) store_release(&status[0], kTilePrefix | aggregate);
    return 0u;
  }
  if (lane == 0) store_release(&status[t], kTileAggregate | aggregate);
  unsigned prefix = 0;
  for (int window = t - 32;; window -= 32) {
    const int p = window + lane;  // lane 31 is the nearest predecessor
    unsigned long long w;
    do {  // before tile 0 reads as an inclusive prefix of 0
      w = p < 0 ? kTilePrefix : load_acquire(&status[p]);
    } while (__any_sync(0xFFFFFFFFu, (w >> 32) == 0));
    // the nearest inclusive prefix and the aggregates after it; with none
    // in the window, every aggregate, and look further back
    const unsigned inclusive = __ballot_sync(0xFFFFFFFFu, (w >> 32) == 2);
    const int nearest = inclusive ? 31 - __clz(inclusive) : 0;
    unsigned v = lane >= nearest ? (unsigned)w : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
    prefix += v;
    if (inclusive) break;
  }
  if (lane == 0) store_release(&status[t], kTilePrefix | (prefix + aggregate));
  return prefix;
}

// Tile t lies whole inside [lead, lead + n) of the 16-byte-aligned frame.
__device__ __forceinline__ bool scan_whole(int t, int lead, int64_t n) {
  return (int64_t)t * kScanTile >= lead &&
         (int64_t)(t + 1) * kScanTile <= n + lead;
}

// One CTA a tile.  status: ntiles zeroed words; counter: a zeroed tile-id
// counter.  x - lead is 16-byte aligned; vec_out says whether out - lead
// is too.
__global__ void __launch_bounds__(kScanThreads)
exclusive_scan_kernel(const int32_t* __restrict__ x, int64_t n, int lead,
                      int32_t* __restrict__ out, bool vec_out,
                      unsigned long long* __restrict__ status,
                      unsigned* __restrict__ counter) {
  __shared__ int4 buf[kScanVecs];
  __shared__ unsigned warp_sum[kScanWarps];
  __shared__ unsigned tile_prefix;
  __shared__ int tile_id;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // Tile ids in the order CTAs start, not blockIdx: every tile this one
  // waits for belongs to a CTA that is already running.
  if (tid == 0) tile_id = (int)atomicAdd(counter, 1u);
  __syncthreads();
  const int t = tile_id;
  const bool is_whole = scan_whole(t, lead, n);
  const int64_t tile_start = (int64_t)t * kScanTile - lead;  // in x

  unsigned v[kScanItems];
  if (is_whole) {
    const int4* src = reinterpret_cast<const int4*>(x + tile_start);
#pragma unroll
    for (int j = 0; j < kScanVecs / kScanThreads; ++j) {
      const int c = j * kScanThreads + tid;
      cp_async16(&buf[scan_swizzle(c)], src + c);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kScanChunks; ++k) {
      const int4 q = buf[scan_swizzle(tid * kScanChunks + k)];
      v[4 * k] = (unsigned)q.x;
      v[4 * k + 1] = (unsigned)q.y;
      v[4 * k + 2] = (unsigned)q.z;
      v[4 * k + 3] = (unsigned)q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      const int64_t e = tile_start + tid * kScanItems + i;
      v[i] = (e >= 0 && e < n) ? (unsigned)x[e] : 0u;
    }
  }
  // serial exclusive scan of the thread's items, then a warp scan of the
  // thread totals, then one step across warps
  unsigned total = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    const unsigned xi = v[i];
    v[i] = total;
    total += xi;
  }
  unsigned incl = total;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  unsigned before = 0, aggregate = 0;
#pragma unroll
  for (int w = 0; w < kScanWarps; ++w) {
    const unsigned ws = warp_sum[w];
    before += w < warp ? ws : 0u;
    aggregate += ws;
  }
  if (warp == 0) {
    const unsigned p = scan_look_back(status, t, aggregate, lane);
    if (lane == 0) tile_prefix = p;
  }
  __syncthreads();
  const unsigned off = tile_prefix + before + incl - total;

  // Stage the results in shared memory (the same swizzled chunks), then
  // store them striped over the CTA.
#pragma unroll
  for (int k = 0; k < kScanChunks; ++k)
    buf[scan_swizzle(tid * kScanChunks + k)] =
        make_int4((int)(off + v[4 * k]), (int)(off + v[4 * k + 1]),
                  (int)(off + v[4 * k + 2]), (int)(off + v[4 * k + 3]));
  __syncthreads();
  if (is_whole && vec_out) {
    int4* dst = reinterpret_cast<int4*>(out + tile_start);
#pragma unroll
    for (int j = 0; j < kScanVecs / kScanThreads; ++j) {
      const int c = j * kScanThreads + tid;
      dst[c] = buf[scan_swizzle(c)];
    }
  } else {
    const int32_t* r = reinterpret_cast<const int32_t*>(buf);
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      const int i = j * kScanThreads + tid;
      const int64_t e = tile_start + i;
      if (e >= 0 && e < n) out[e] = r[scan_swizzle(i >> 2) * 4 + (i & 3)];
    }
  }
}

long long scan_tiles(long long n, int lead) {
  return (n + lead + kScanTile - 1) / kScanTile;
}

// ------------------------------------------------------- pass histograms
//
// Replaces, on the sort and partition path, the once-a-pass calls of
// radix_sort_tpu/ops/pallas_radix.py:140 digit_histogram (K1): the digit
// counts of every pass of a sort, a (P, R) int32 table, from one read of
// each key word plane.  Plane w counts passes[w] digits, the digit of pass
// j being (x >> j * bits) & (R - 1), into rows row0[w] + j.
//
// Bound by bytes: 4 bytes an element and plane, read once, and the small
// table (0.160 ms for 2^27 u32 keys at 3.35 TB/s, where one read a pass
// took four).  What the design does about that bound:
//
//   - 16-byte loads, two in flight a lane, warps striding over the plane;
//     three CTAs an SM keep ~48 KB of loads in flight.
//   - Counts go to shared memory, one table copy for each warp of a group
//     of eight, so warps do not contend; each CTA adds its copies into the
//     global table with one atomic a (pass, digit) at its end.
//   - A warp whose 128 digits of a pass are all equal (Zeros, the high
//     digits of small or sorted keys) adds 128 with one atomic of one
//     lane; otherwise every lane adds its four digits with shared atomics,
//     which random digits spread over R addresses.
//   - Elements before the first 16-byte boundary and after the last whole
//     vector (at most six) are counted element by element by CTA 0.
//   - A narrow key plane (one plane, the caller's 1- or 2-byte keys) is
//     read at its own width: each 16-byte vector holds 16 or 8 keys, each
//     unpacked and taken to its image in registers.
constexpr int kHistThreads = 512;
constexpr int kHistWarps = kHistThreads / 32;
constexpr int kHistCopies = 8;
constexpr int kHistMaxCells = 1024;  // (32 / bits) * 2^bits, bits <= 8
constexpr int kHistUnroll = 2;       // 16-byte vectors a lane loads at once
constexpr int kHistMaxPlanes = 2;

struct HistPlanes {
  const void* x[kHistMaxPlanes];
  int passes[kHistMaxPlanes];
  int row0[kHistMaxPlanes];
};

// The K = 16 / KB keys of a 16-byte vector of a narrow plane, as images.
template <int KB>
__device__ __forceinline__ void unpack16(int4 q, KeyKind kk,
                                         unsigned (&v)[16 / KB]) {
  constexpr int kPer = 4 / KB;  // keys a 32-bit word
  const unsigned w[4] = {(unsigned)q.x, (unsigned)q.y, (unsigned)q.z,
                         (unsigned)q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < kPer; ++b)
      v[i * kPer + b] =
          key_image<KB>((w[i] >> (8 * KB * b)) & kKeyMask<KB>, kk);
}

__device__ __forceinline__ void hist_add4(int* h, int4 q, bool ok,
                                          unsigned valid, int passes,
                                          int bits, int lane) {
  const unsigned mask = (1u << bits) - 1u;
  for (int p = 0; p < passes; ++p) {
    const int s = p * bits;
    const unsigned d0 = ((unsigned)q.x >> s) & mask;
    const unsigned d1 = ((unsigned)q.y >> s) & mask;
    const unsigned d2 = ((unsigned)q.z >> s) & mask;
    const unsigned d3 = ((unsigned)q.w >> s) & mask;
    int* row = h + (p << bits);
    const unsigned ref = __shfl_sync(0xFFFFFFFFu, d0, 0);  // lane 0 is valid
    const bool same = !ok || (d0 == ref && d1 == ref && d2 == ref && d3 == ref);
    if (__all_sync(0xFFFFFFFFu, same)) {
      if (lane == 0) atomicAdd(&row[ref], 4 * __popc(valid));
    } else if (ok) {
      atomicAdd(&row[d0], 1);
      atomicAdd(&row[d1], 1);
      atomicAdd(&row[d2], 1);
      atomicAdd(&row[d3], 1);
    }
  }
}

// hist_add4 for the K keys (images) a lane unpacked from a narrow plane's
// 16-byte vector.
template <int K>
__device__ __forceinline__ void hist_add(int* h, const unsigned (&v)[K],
                                         bool ok, unsigned valid, int passes,
                                         int bits, int lane) {
  const unsigned mask = (1u << bits) - 1u;
  for (int p = 0; p < passes; ++p) {
    const int s = p * bits;
    int* row = h + (p << bits);
    // lane 0 is valid
    const unsigned ref = __shfl_sync(0xFFFFFFFFu, (v[0] >> s) & mask, 0);
    bool same = true;
#pragma unroll
    for (int k = 0; k < K; ++k) same &= ((v[k] >> s) & mask) == ref;
    if (__all_sync(0xFFFFFFFFu, !ok || same)) {
      if (lane == 0) atomicAdd(&row[ref], K * __popc(valid));
    } else if (ok) {
#pragma unroll
      for (int k = 0; k < K; ++k) atomicAdd(&row[(v[k] >> s) & mask], 1);
    }
  }
}

// grid: (CTAs a plane, planes).  out: zeroed (P, R) table.  KB: the bytes
// of a key of every plane.
template <int KB>
__global__ void __launch_bounds__(kHistThreads)
pass_histograms_kernel(HistPlanes hp, int64_t n, int bits, KeyKind kk,
                       int32_t* __restrict__ out) {
  using K = typename KeyWord<KB>::T;
  constexpr int kPer = 16 / KB;  // keys a 16-byte vector
  __shared__ int hist[kHistCopies * kHistMaxCells];
  const int plane = blockIdx.y;
  const K* x = static_cast<const K*>(hp.x[plane]);
  const int passes = hp.passes[plane];
  const int cells = passes << bits;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < kHistCopies * cells; i += kHistThreads) hist[i] = 0;
  __syncthreads();
  int* h = hist + (warp % kHistCopies) * cells;

  // [0, head) and [head + kPer * nvec, n) go element by element
  const int64_t lead = (int64_t)((16u - ((uintptr_t)x & 15u)) & 15u) / KB;
  const int64_t head = lead < n ? lead : n;
  const int64_t nvec = (n - head) / kPer;
  const int4* x4 = reinterpret_cast<const int4*>(x + head);
  constexpr int64_t kWarpVecs = 32 * kHistUnroll;
  const int64_t step = (int64_t)gridDim.x * kHistWarps * kWarpVecs;
  for (int64_t v0 = ((int64_t)blockIdx.x * kHistWarps + warp) * kWarpVecs;
       v0 < nvec; v0 += step) {
    int4 q[kHistUnroll];
    bool ok[kHistUnroll];
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) {
      const int64_t v = v0 + u * 32 + lane;
      ok[u] = v < nvec;
      q[u] = ok[u] ? x4[v] : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) {
      const unsigned valid = __ballot_sync(0xFFFFFFFFu, ok[u]);
      if (valid == 0) break;  // the valid lanes are a prefix of the warp
      if constexpr (KB == 4) {
        hist_add4(h, q[u], ok[u], valid, passes, bits, lane);
      } else {
        unsigned v[kPer];
        unpack16<KB>(q[u], kk, v);
        hist_add<kPer>(h, v, ok[u], valid, passes, bits, lane);
      }
    }
  }
  if (blockIdx.x == 0) {
    const unsigned mask = (1u << bits) - 1u;
    const int64_t tail = head + kPer * nvec;
    const int64_t rest = head + (n - tail);
    for (int64_t k = tid; k < rest; k += kHistThreads) {
      const unsigned v = key_image<KB>(
          (unsigned)x[k < head ? k : tail + (k - head)], kk);
      for (int p = 0; p < passes; ++p)
        atomicAdd(&h[(p << bits) + ((v >> (p * bits)) & mask)], 1);
    }
  }
  __syncthreads();
  int32_t* o = out + ((int64_t)hp.row0[plane] << bits);
  for (int i = tid; i < cells; i += kHistThreads) {
    int c = 0;
#pragma unroll
    for (int k = 0; k < kHistCopies; ++k) c += hist[k * cells + i];
    if (c) atomicAdd(&o[i], c);
  }
}

// The (tile, threads) shapes rank_scatter_shape dispatches on.
bool rank_shape_ok(int tile, int threads) {
  return (threads == 256 && (tile == 8192 || tile == 4096 || tile == 2048)) ||
         (threads == 128 && (tile == 4096 || tile == 2048));
}

// rank_scatter_wide_kernel where some plane of the launch is 8 bytes an
// element.
template <bool LOOKBACK, typename Word>
bool rank_scatter_launch(int key_bytes, int tile, int threads,
                         const PassArgs& a, cudaStream_t s) {
  if (a.wide)
    return rank_scatter_wide(a, LOOKBACK, sizeof(Word) == 8, key_bytes, tile,
                             threads, s);
  return rank_scatter_keyed<LOOKBACK, Word, false>(key_bytes, tile, threads,
                                                   a, s);
}

int radix_bits(int radix) {
  int b = 0;
  while ((1 << b) < radix) ++b;
  return b;
}

// Bytes of one look-back pass's scratch: the tile-id counter (16 bytes,
// so the words stay aligned), then one status word a (tile, digit).
long long onesweep_pass_bytes(long long n, int tile, int radix) {
  const long long word = n < (1ll << 30) ? 4 : 8;
  const long long bytes = 16 + (n + tile - 1) / tile * radix * word;
  return (bytes + 15) / 16 * 16;
}

// tmps may be null: a launch with no plan, or of a sort of one pass, never
// writes TMP.  plane_bytes: the bytes an element of each plane, or null
// when every plane is int32 (a narrow key plane gives its own width); the
// 8-byte planes set their bits of *wide and must be 8-byte aligned.
bool fill_planes(Planes& planes, const void* const* ins, void* const* outs,
                 void* const* tmps, int nplanes, const int* plane_bytes,
                 unsigned* wide) {
  if (nplanes < 0 || nplanes > kMaxPlanes) return false;
  const void* const* sets[kSets] = {ins, outs, tmps ? tmps : outs};
  *wide = 0u;
  for (int b = 0; b < kSets; ++b)
    for (int p = 0; p < kMaxPlanes; ++p)
      planes.buf[b][p] = p < nplanes ? (int32_t*)sets[b][p] : nullptr;
  for (int p = 0; plane_bytes != nullptr && p < nplanes; ++p) {
    const int w = plane_bytes[p];
    if (w != 1 && w != 2 && w != 4 && w != 8) return false;
    if (w != 8) continue;
    for (int b = 0; b < kSets; ++b)
      if ((uintptr_t)planes.buf[b][p] % 8) return false;
    *wide |= 1u << p;
  }
  return true;
}

// The digit plane in IN, OUT and TMP (digsrc[3]; OUT and TMP may be null
// with no plan) and the plan (table null: none; key0: the sort's key
// planes in IN, one or two).
bool fill_plan(PassArgs& a, const void* const* digsrc, const void* table,
               int npasses, int passes0, int pass, const void* const* key0) {
  for (int b = 0; b < kSets; ++b)
    a.digit.buf[b] = digsrc[b] ? digsrc[b] : digsrc[kIn];
  a.plan = {(const int32_t*)table, {nullptr, nullptr}, npasses, passes0,
            pass};
  if (table == nullptr) return true;
  if (npasses < 1 || npasses > kMaxPasses || passes0 < 1 ||
      passes0 > npasses || pass < 0 || pass >= npasses || key0 == nullptr ||
      key0[0] == nullptr || (passes0 < npasses && key0[1] == nullptr))
    return false;
  a.plan.key0[0] = key0[0];
  a.plan.key0[1] = passes0 < npasses ? key0[1] : nullptr;
  return true;
}

bool radix_ok(int radix) {
  return radix >= 2 && radix <= kMaxRadix && (radix & (radix - 1)) == 0;
}

// The current device's SM count, asked once a device.
int num_sms() {
  static std::atomic<unsigned long long> known{0};
  static std::atomic<int> count[64];
  int dev = 0, sms = 0;
  if (!todo_on_device(known, &dev)) return count[dev].load();
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  sms = sms > 0 ? sms : 1;
  if (dev >= 0 && dev < 64) {
    count[dev].store(sms);
    mark_device(known, dev);
  }
  return sms;
}

// The pass_histograms launch over a zeroed (passes0 + passes1, R) table
// `out`: x0 carries passes0 passes, x1 (if passes1 > 0) the next passes1.
void launch_pass_histograms(const void* x0, int passes0, const void* x1,
                            int passes1, long long n, int bits, int key_bytes,
                            KeyKind kk, int32_t* out, cudaStream_t s) {
  const HistPlanes hp = {{x0, x1}, {passes0, passes1}, {0, passes0}};
  const long long per_cta = (long long)kHistWarps * 32 * kHistUnroll * 16 /
                            key_bytes;
  long long ctas = (n + per_cta - 1) / per_cta;
  const long long most = 3ll * num_sms();
  if (ctas > most) ctas = most;
  const dim3 grid((unsigned)ctas, passes1 > 0 ? 2u : 1u);
  if (key_bytes == 4)
    pass_histograms_kernel<4><<<grid, kHistThreads, 0, s>>>(hp, n, bits, kk,
                                                            out);
  else if (key_bytes == 2)
    pass_histograms_kernel<2><<<grid, kHistThreads, 0, s>>>(hp, n, bits, kk,
                                                            out);
  else
    pass_histograms_kernel<1><<<grid, kHistThreads, 0, s>>>(hp, n, bits, kk,
                                                            out);
}

// Whether pass_histograms takes these planes: passes0 digits of bits bits
// within keys of key_bytes bytes at x0, and passes1 (>= 0) within the int32
// words at x1, a second plane that only 4-byte keys have.
bool hist_planes_ok(const void* x0, int passes0, const void* x1, int passes1,
                    int bits, int key_bytes) {
  return passes0 >= 1 && passes1 >= 0 && (key_bytes == 4 || passes1 == 0) &&
         (uintptr_t)x0 % key_bytes == 0 &&
         (passes1 == 0 || (uintptr_t)x1 % 4 == 0) &&
         (passes0 - 1) * bits < 8 * key_bytes && (passes1 - 1) * bits <= 31;
}

// One rst_sort_planes call's workspace, in bytes from its 16-byte aligned
// start: the (P, R) pass table, then P look-back scratch rows (each
// onesweep_pass_bytes, so each stays 16-byte aligned), zeroed together by
// one memset; then, past kMaxPlanes planes, the (R, B) tile bases, which
// every pass's look-back launch writes before its base-table launches read
// them, so they are not zeroed.
struct SortLayout {
  long long rows;    // offset of the first scratch row
  long long row;     // bytes a scratch row
  long long zeroed;  // the table and the rows
  long long total;   // and the tile bases
};

SortLayout sort_layout(long long n, int tile, int radix, int npasses,
                       int nplanes) {
  SortLayout l;
  l.rows = ((long long)npasses * radix * 4 + 15) / 16 * 16;
  l.row = onesweep_pass_bytes(n, tile, radix);
  l.zeroed = l.rows + npasses * l.row;
  const long long nblocks = (n + tile - 1) / tile;
  l.total = l.zeroed + (nplanes > kMaxPlanes ? radix * nblocks * 4 : 0);
  return l;
}

// The digit source holds keys of key_bytes bytes (1, 2 or 4) of kind `kind`
// (0 unsigned, 1 signed, 2 float; a 4-byte word plane is 0): see KeyKind.
// A plane of a set equal to that set's digit plane is the key plane, moved
// at its own width; every other plane is int32.
bool pass_key_ok(int key_bytes, int kind, int shift, KeyKind* kk) {
  return key_kind(key_bytes, kind, kk) && shift >= 0 &&
         shift < 8 * key_bytes;
}

}  // namespace

extern "C" {

int rst_max_planes() { return kMaxPlanes; }

// counts of block b and digit d go to out[b * stride_b + d * stride_d].
int rst_digit_histogram(const void* x, long long n, int tile, int threads,
                        int shift, int radix, void* out, long long stride_b,
                        long long stride_d, void* stream) {
  if (!radix_ok(radix) || tile <= 0 || n <= 0 || shift < 0 || shift > 31)
    return (int)cudaErrorInvalidValue;
  const long long nblocks = (n + tile - 1) / tile;
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* xi = (const int32_t*)x;
  int32_t* o = (int32_t*)out;
  if (threads == 256) {
    digit_histogram_kernel<256><<<(unsigned)nblocks, 256, 0, s>>>(
        xi, n, tile, shift, radix, o, stride_b, stride_d);
  } else if (threads == 128) {
    digit_histogram_kernel<128><<<(unsigned)nblocks, 128, 0, s>>>(
        xi, n, tile, shift, radix, o, stride_b, stride_d);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Bytes of scratch rst_exclusive_scan needs for n elements, whatever the
// alignment of x: a tile-id counter, then one status word a tile.
long long rst_scan_scratch_bytes(long long n) {
  return n <= 0 ? 0 : 8 * (1 + scan_tiles(n, 3));
}

// One memset of the scratch and one launch, both on `stream`, so scans on
// two streams with two scratch buffers share no state.
int rst_exclusive_scan(const void* x, long long n, void* out, void* scratch,
                       long long scratch_bytes, void* stream) {
  const uintptr_t xa = (uintptr_t)x;
  if (n <= 0 || n >= (1ll << 31) || xa % 4 || (uintptr_t)out % 4 ||
      (uintptr_t)scratch % 8)
    return (int)cudaErrorInvalidValue;
  const int lead = (int)(xa % 16 / 4);
  const long long ntiles = scan_tiles(n, lead);
  const long long bytes = 8 * (1 + ntiles);
  if (bytes > scratch_bytes) return (int)cudaErrorInvalidValue;
  const bool vec_out = ((uintptr_t)out - 4u * (unsigned)lead) % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(scratch, 0, (size_t)bytes, s);
  if (e != cudaSuccess) return (int)e;
  exclusive_scan_kernel<<<(unsigned)ntiles, kScanThreads, 0, s>>>(
      (const int32_t*)x, n, lead, (int32_t*)out, vec_out,
      (unsigned long long*)scratch + 1, (unsigned*)scratch);
  return (int)cudaGetLastError();
}

// base: (R, nblocks) int32, digit-major.  ins/outs/tmps: host arrays of
// nplanes device pointers (nplanes <= rst_max_planes()), the planes in IN,
// OUT and TMP; tmps may be null.  plane_bytes: a host array of each
// plane's bytes an element (8 for a payload plane moved at 8 bytes), or
// null when none is 8.  digsrc: the digit plane in IN, OUT and TMP (OUT
// and TMP may be null with no plan).  dest may be null.  The plan: table
// (P = npasses rows of radix), null for none; passes0 and key0 (one or two
// key planes in IN) as in Plan; pass, this launch's row.
int rst_rank_scatter(const void* const* digsrc, long long n, int tile,
                     int threads, int shift, int radix, int key_bytes,
                     int kind, const void* base, const void* const* ins,
                     void* const* outs, void* const* tmps, int nplanes,
                     const int* plane_bytes, void* dest, const void* table,
                     int npasses, int passes0, int pass,
                     const void* const* key0, void* stream) {
  PassArgs a;
  if (!radix_ok(radix) || n <= 0 || n >= (1ll << 31) || tile <= 0 ||
      !pass_key_ok(key_bytes, kind, shift, &a.kk) ||
      !fill_planes(a.planes, ins, outs, tmps, nplanes, plane_bytes,
                   &a.wide) ||
      !fill_plan(a, digsrc, table, npasses, passes0, pass, key0))
    return (int)cudaErrorInvalidValue;
  a.n = n;
  a.shift = shift;
  a.bits = radix_bits(radix);
  a.base = (const int32_t*)base;
  a.lb = {nullptr, nullptr, nullptr, nullptr};
  a.nblocks = (n + tile - 1) / tile;
  a.nplanes = nplanes;
  a.dest = (int32_t*)dest;
  if (!rank_scatter_launch<false, unsigned>(key_bytes, tile, threads, a,
                                            (cudaStream_t)stream))
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Digit counts of every pass: plane x0 carries passes0 passes (rows 0 ..
// passes0 - 1 of out), x1, if passes1 > 0, the next passes1.  out: (passes0
// + passes1, radix) int32, zeroed here on `stream` before the launch.  A
// narrow key plane (key_bytes 1 or 2, of kind `kind` as in rst_rank_scatter)
// goes alone, as x0; two planes are int32 words.
int rst_pass_histograms(const void* x0, int passes0, const void* x1,
                        int passes1, long long n, int radix, int key_bytes,
                        int kind, void* out, void* stream) {
  const int bits = radix_bits(radix);
  KeyKind kk;
  if (!radix_ok(radix) || n <= 0 || n >= (1ll << 31) ||
      !key_kind(key_bytes, kind, &kk) ||
      !hist_planes_ok(x0, passes0, x1, passes1, bits, key_bytes))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int rows = passes0 + passes1;
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)rows * radix * 4, s);
  if (e != cudaSuccess) return (int)e;
  launch_pass_histograms(x0, passes0, x1, passes1, n, bits, key_bytes, kk,
                         (int32_t*)out, s);
  return (int)cudaGetLastError();
}

// Bytes of scratch one look-back pass over n elements needs: a tile-id
// counter and one status word a (tile, digit), 32 bits while n < 2^30,
// else 64; a multiple of 16, so a sort's passes can share one buffer.
long long rst_onesweep_scratch_bytes(long long n, int tile, int radix) {
  return n <= 0 || tile <= 0 ? 0 : onesweep_pass_bytes(n, tile, radix);
}

// Zero `bytes` at p on `stream`: the scratch of every pass of a sort at
// once.
int rst_zero(void* p, long long bytes, void* stream) {
  if (bytes < 0) return (int)cudaErrorInvalidValue;
  return (int)cudaMemsetAsync(p, 0, (size_t)bytes, (cudaStream_t)stream);
}

// One look-back pass.  counts: (R,) digit totals of the pass (a row of
// rst_pass_histograms).  scratch: this pass's zeroed
// rst_onesweep_scratch_bytes.  base_out: (R, nblocks) int32 tile bases, or
// null.  dest may be null.  key_bytes, kind, the planes and the plan as in
// rst_rank_scatter.
int rst_onesweep_pass(const void* const* digsrc, long long n, int tile,
                      int threads, int shift, int radix, int key_bytes,
                      int kind, const void* counts, void* scratch,
                      long long scratch_bytes, const void* const* ins,
                      void* const* outs, void* const* tmps, int nplanes,
                      const int* plane_bytes, void* dest, void* base_out,
                      const void* table, int npasses, int passes0, int pass,
                      const void* const* key0, void* stream) {
  PassArgs a;
  if (!radix_ok(radix) || n <= 0 || n >= (1ll << 31) || tile <= 0 ||
      !pass_key_ok(key_bytes, kind, shift, &a.kk) ||
      (uintptr_t)scratch % 16 ||
      scratch_bytes < onesweep_pass_bytes(n, tile, radix) ||
      !fill_planes(a.planes, ins, outs, tmps, nplanes, plane_bytes,
                   &a.wide) ||
      !fill_plan(a, digsrc, table, npasses, passes0, pass, key0))
    return (int)cudaErrorInvalidValue;
  a.n = n;
  a.shift = shift;
  a.bits = radix_bits(radix);
  a.base = nullptr;
  a.lb = {(const int32_t*)counts, (char*)scratch + 16, (unsigned*)scratch,
          (int32_t*)base_out};
  a.nblocks = (n + tile - 1) / tile;
  a.nplanes = nplanes;
  a.dest = (int32_t*)dest;
  cudaStream_t s = (cudaStream_t)stream;
  const bool ok =
      n < (1ll << 30)
          ? rank_scatter_launch<true, unsigned>(key_bytes, tile, threads, a, s)
          : rank_scatter_launch<true, unsigned long long>(key_bytes, tile,
                                                          threads, a, s);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Bytes of the workspace rst_sort_planes needs for P = npasses passes of
// nplanes planes of n elements (0 for arguments it refuses).
long long rst_sort_workspace_bytes(long long n, int tile, int radix,
                                   int npasses, int nplanes) {
  if (n <= 0 || tile <= 0 || !radix_ok(radix) || npasses < 1 ||
      npasses > kMaxPasses || nplanes < 0)
    return 0;
  return sort_layout(n, tile, radix, npasses, nplanes).total;
}

// A whole sort or partition, enqueued on `stream` with no host read and no
// sync: one memset of the workspace's pass table and scratch rows, one
// pass_histograms launch into the table, then for each of the P = passes0
// + passes1 passes one look-back launch of the first kMaxPlanes planes and
// one base-table launch of each further group of kMaxPlanes, each from the
// tile bases its pass's look-back launch wrote, every launch with the
// sort's Plan.  What rst_pass_histograms, rst_onesweep_pass and
// rst_rank_scatter launch for a sort, in one call.
//
// keys: the key planes in IN, keys[0] with passes0 passes, keys[1] with
// passes1 (read only when passes1 > 0).  digit_moves: keys[w] is ins[w] and
// moves with the planes; else keys[0] is a digit plane that does not move
// (a partition's ids: int32, passes1 0).  key_bytes and kind are keys[0]'s,
// the planes' sets and plane_bytes as in rst_rank_scatter, any number of
// planes (tmps may be null when P is 1); a key plane is never 8 bytes.
// workspace: rst_sort_workspace_bytes(n, tile, radix, P, nplanes) bytes,
// 16-byte aligned; its first P * radix int32 hold the pass table after the
// call.  launches[3] is set to the pass_histograms, look-back and
// base-table launches made.
int rst_sort_planes(long long n, int radix, int tile, int threads,
                    int key_bytes, int kind, const void* const* keys,
                    int passes0, int passes1, const void* const* ins,
                    void* const* outs, void* const* tmps, int nplanes,
                    const int* plane_bytes, int digit_moves, void* workspace,
                    long long workspace_bytes, void* stream, int* launches) {
  const int bits = radix_bits(radix);
  const int npasses = passes0 + passes1;
  const int nkeys = passes1 > 0 ? 2 : 1;
  if (keys == nullptr || launches == nullptr)
    return (int)cudaErrorInvalidValue;
  const void* key0 = keys[0];
  const void* key1 = passes1 > 0 ? keys[1] : nullptr;
  KeyKind kk;
  if (!radix_ok(radix) || n <= 0 || n >= (1ll << 31) ||
      !rank_shape_ok(tile, threads) || !key_kind(key_bytes, kind, &kk) ||
      key0 == nullptr || (passes1 > 0 && key1 == nullptr) ||
      !hist_planes_ok(key0, passes0, key1, passes1, bits, key_bytes) ||
      npasses > kMaxPasses || nplanes < 0 ||
      (nplanes > 0 && (ins == nullptr || outs == nullptr)) ||
      (npasses > 1 && nplanes > 0 && tmps == nullptr) ||
      (uintptr_t)workspace % 16 ||
      workspace_bytes <
          sort_layout(n, tile, radix, npasses, nplanes).total)
    return (int)cudaErrorInvalidValue;
  if (digit_moves) {
    if (nplanes < nkeys) return (int)cudaErrorInvalidValue;
    for (int w = 0; w < nkeys; ++w)
      if (keys[w] != ins[w] || (plane_bytes && plane_bytes[w] == 8))
        return (int)cudaErrorInvalidValue;
  } else if (passes1 > 0 || key_bytes != 4) {
    return (int)cudaErrorInvalidValue;
  }
  // every group's planes checked before anything is enqueued
  const int groups = nplanes > kMaxPlanes
                         ? (nplanes + kMaxPlanes - 1) / kMaxPlanes
                         : 1;
  PassArgs a;
  for (int g = 0; g < groups; ++g) {
    const int lo = g * kMaxPlanes;
    const int k = nplanes - lo < kMaxPlanes ? nplanes - lo : kMaxPlanes;
    if (!fill_planes(a.planes, ins ? ins + lo : nullptr,
                     outs ? outs + lo : nullptr, tmps ? tmps + lo : nullptr,
                     k, plane_bytes ? plane_bytes + lo : nullptr, &a.wide))
      return (int)cudaErrorInvalidValue;
  }
  const SortLayout l = sort_layout(n, tile, radix, npasses, nplanes);
  cudaStream_t s = (cudaStream_t)stream;
  char* ws = (char*)workspace;
  int32_t* table = (int32_t*)ws;
  int32_t* bases = nplanes > kMaxPlanes ? (int32_t*)(ws + l.zeroed) : nullptr;
  cudaError_t e = cudaMemsetAsync(ws, 0, (size_t)l.zeroed, s);
  if (e != cudaSuccess) return (int)e;
  launch_pass_histograms(key0, passes0, key1, passes1, n, bits, key_bytes,
                         kk, table, s);
  launches[0] = 1;
  launches[1] = launches[2] = 0;
  a.n = n;
  a.bits = bits;
  a.kk = kk;
  a.nblocks = (n + tile - 1) / tile;
  a.dest = nullptr;
  for (int p = 0; p < npasses; ++p) {
    const int w = p < passes0 ? 0 : 1;
    a.shift = (w ? p - passes0 : p) * bits;
    if (digit_moves) {
      a.digit.buf[kIn] = ins[w];
      a.digit.buf[kOut] = outs[w];
      a.digit.buf[kTmp] = tmps ? tmps[w] : outs[w];
    } else {
      a.digit.buf[kIn] = a.digit.buf[kOut] = a.digit.buf[kTmp] = key0;
    }
    a.plan = {table, {key0, key1}, npasses, passes0, p};
    for (int g = 0; g < groups; ++g) {
      const int lo = g * kMaxPlanes;
      const int k = nplanes - lo < kMaxPlanes ? nplanes - lo : kMaxPlanes;
      fill_planes(a.planes, ins ? ins + lo : nullptr,
                  outs ? outs + lo : nullptr, tmps ? tmps + lo : nullptr, k,
                  plane_bytes ? plane_bytes + lo : nullptr, &a.wide);
      a.nplanes = k;
      if (g == 0) {
        char* row = ws + l.rows + p * l.row;
        a.base = nullptr;
        a.lb = {table + (long long)p * radix, row + 16, (unsigned*)row,
                bases};
        if (n < (1ll << 30))
          rank_scatter_launch<true, unsigned>(key_bytes, tile, threads, a, s);
        else
          rank_scatter_launch<true, unsigned long long>(key_bytes, tile,
                                                        threads, a, s);
        ++launches[1];
      } else {
        a.base = bases;
        a.lb = {nullptr, nullptr, nullptr, nullptr};
        rank_scatter_launch<false, unsigned>(key_bytes, tile, threads, a, s);
        ++launches[2];
      }
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
