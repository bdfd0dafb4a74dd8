// Radix-pass kernels for NVIDIA Hopper (sm_90a), bound to Python with ctypes.
//
// A sort (or a partition) is a onesweep LSD radix sort over int32 planes:
//
//   pass_histograms  the digit counts of every pass, (P, R), from one read
//                    of each key word plane; the host reads them once to
//                    skip the passes one digit fills
//   rank_scatter     one launch a pass in look-back mode: each tile ranks
//                    its elements, finds its global digit offsets by
//                    decoupled look-back over the tiles before it, and
//                    scatters the digit plane and every payload plane
//                    through a shared-memory staging tile
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
// Every C entry point takes device pointers and the CUDA stream as opaque
// pointers, launches on that stream, never synchronises, allocates nothing,
// and returns cudaGetLastError() so the Python wrapper can raise.
//
// Tiles are masked at the ragged end inside the kernels: no input is padded.
// Element counts must stay below 2^31 (destinations are int32); the wrappers
// check that.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRadix = 256;
constexpr int kMaxPlanes = 16;

struct Planes {
  const int32_t* in[kMaxPlanes];
  int32_t* out[kMaxPlanes];
};

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
constexpr unsigned long long kTileAggregate = 1ull << 32;
constexpr unsigned long long kTilePrefix = 2ull << 32;

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
constexpr int kHistThreads = 512;
constexpr int kHistWarps = kHistThreads / 32;
constexpr int kHistCopies = 8;
constexpr int kHistMaxCells = 1024;  // (32 / bits) * 2^bits, bits <= 8
constexpr int kHistUnroll = 2;       // 16-byte vectors a lane loads at once
constexpr int kHistMaxPlanes = 2;

struct HistPlanes {
  const int32_t* x[kHistMaxPlanes];
  int passes[kHistMaxPlanes];
  int row0[kHistMaxPlanes];
};

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

// grid: (CTAs a plane, planes).  out: zeroed (P, R) table.
__global__ void __launch_bounds__(kHistThreads)
pass_histograms_kernel(HistPlanes hp, int64_t n, int bits,
                       int32_t* __restrict__ out) {
  __shared__ int hist[kHistCopies * kHistMaxCells];
  const int plane = blockIdx.y;
  const int32_t* x = hp.x[plane];
  const int passes = hp.passes[plane];
  const int cells = passes << bits;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < kHistCopies * cells; i += kHistThreads) hist[i] = 0;
  __syncthreads();
  int* h = hist + (warp % kHistCopies) * cells;

  // [0, head) and [head + 4 * nvec, n) go element by element
  const int64_t lead = (int64_t)((16u - ((uintptr_t)x & 15u)) & 15u) / 4;
  const int64_t head = lead < n ? lead : n;
  const int64_t nvec = (n - head) / 4;
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
      hist_add4(h, q[u], ok[u], valid, passes, bits, lane);
    }
  }
  if (blockIdx.x == 0) {
    const unsigned mask = (1u << bits) - 1u;
    const int64_t tail = head + 4 * nvec;
    const int64_t rest = head + (n - tail);
    for (int64_t k = tid; k < rest; k += kHistThreads) {
      const unsigned v = (unsigned)x[k < head ? k : tail + (k - head)];
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

// ------------------------------------------------ rank + scatter, onesweep
//
// Replaces radix_sort_tpu/ops/pallas_radix.py:263 rank_pass (_rank_kernel)
// with the XLA scatter of ops/ranking.py:apply_destinations after it (K3),
// and radix_sort_tpu/ops/pallas_stream.py:427 _radix_pass (_pass_kernel)
// with its XLA epilogue _boundary_fixup (K4).  One CTA owns one tile of
// THREADS * ITEMS elements, ranks it and moves every plane.  One kernel
// body has two modes:
//
//   look-back (the sort and the partition): a onesweep pass (Adinets &
//     Merrill, "Onesweep", 2022).  The tile takes its id from a counter in
//     the order CTAs start, publishes its R digit counts as aggregates,
//     and each of R threads walks back over its digit's status words of
//     earlier tiles to the nearest inclusive prefix, then publishes its
//     own.  The tile's global base for digit d is that prefix plus the
//     pass's digit start, a scan of the pass's (R,) totals from
//     pass_histograms.  No histogram or scan launch runs a pass.
//   base table (rank_scatter / rank_pass): the (R, B) digit-major offsets
//     of _stitch_block_base give each tile's base.
//
// Bound by bytes: each moved plane is read and written once (8 bytes an
// element and plane), the digit plane read once more when it is not
// moved; a u32 KV pass at 2^27 moves 2.15 GB, 0.641 ms at 3.35 TB/s.  What
// the design does about that bound:
//
//   - Ranking.  Warp w ranks its own 32 * ITEMS consecutive elements in
//     element order, a round of 32 at a time: each lane ORs its bit into
//     its digit's word of the warp's lane-mask row in shared memory, reads
//     the word back (the lanes that share its digit), and the lowest of
//     them adds their count to the warp's own counter row.  No CTA barrier
//     runs inside the rounds.  One barrier, then one thread a digit scans
//     the warp rows into each warp's offset: warp-major order keeps the
//     pass stable.  A round whose lanes share one digit skips the masks.
//     (__match_any_sync took 1.14 device-ms to rank 2^27 keys where the
//     lane masks take 0.61, and one ballot a digit bit was slower too:
//     scripts/pass_variants.py, PERF.md.)
//   - Status words are {2 flag bits, count}: 32 bits while n < 2^30, 64
//     bits above; the host chooses by n.  The word carries its own value
//     and publishes nothing else, so it is stored and loaded relaxed at
//     device scope: with st.release / ld.acquire a u32 KV pass at 2^27
//     took 1.52 ms, relaxed 1.32.  A digit's thread walks back one tile at
//     a time; reading 8 predecessors at once was no faster.  A pass's
//     scratch is one tile-id counter and B * R words, zeroed with the
//     sort's other passes by one memset before the first.
//   - Scatter.  Each plane is staged in shared memory in digit order
//     (payloads come in by 16-byte loads where the tile is whole and the
//     plane aligned, through a table of slots), then written out so that
//     neighbouring threads write neighbouring addresses inside each
//     digit's run.  Prefetching the first payload's tile by cp.async
//     during the ranking gained nothing.
//   - More planes than one launch takes: the look-back launch writes its
//     tile bases, and later launches run in base-table mode from them.
//   - Tiles.  The sort's default, 8192 elements of 256 threads, takes
//     ~70 KB of shared memory (the lane masks share the staging tile's
//     space) and two CTAs an SM; it amortizes the per-tile barriers and
//     look-back over twice the elements of 4096 (1.32 against 1.49 ms a
//     u32 KV pass at 2^27: scripts/onesweep_probe.py).  4096-element
//     tiles keep three CTAs of 256 threads an SM in <= 85 registers; a
//     fourth (64 registers) was slower.
template <typename Word>
struct StatusWord;

template <>
struct StatusWord<unsigned> {
  static constexpr unsigned kAggregate = 1u << 30;
  static constexpr unsigned kPrefix = 2u << 30;
  __device__ static unsigned flag(unsigned w) { return w >> 30; }
  __device__ static unsigned value(unsigned w) { return w & (kAggregate - 1u); }
  __device__ static unsigned load(const unsigned* p) {
    unsigned v;
    asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n"
                 : "=r"(v)
                 : "l"(p)
                 : "memory");
    return v;
  }
  __device__ static void store(unsigned* p, unsigned v) {
    asm volatile("st.relaxed.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v)
                 : "memory");
  }
};

template <>
struct StatusWord<unsigned long long> {
  static constexpr unsigned long long kAggregate = kTileAggregate;
  static constexpr unsigned long long kPrefix = kTilePrefix;
  __device__ static unsigned flag(unsigned long long w) {
    return (unsigned)(w >> 32);
  }
  __device__ static unsigned long long value(unsigned long long w) {
    return w & 0xFFFFFFFFull;
  }
  __device__ static unsigned long long load(const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
                 : "=l"(v)
                 : "l"(p)
                 : "memory");
    return v;
  }
  __device__ static void store(unsigned long long* p, unsigned long long v) {
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
                 : "memory");
  }
};


struct LookBack {
  const int32_t* counts;  // (R,) digit totals of the pass
  void* status;           // (B, R) zeroed status words
  unsigned* counter;      // zeroed tile-id counter
  int32_t* base_out;      // (R, B) tile bases, or null
};

// The kernel's shared memory, dynamic because an 8192-element tile needs
// more than the 48 KB a kernel may declare statically.
template <int THREADS, int ITEMS>
struct RankShared {
  static constexpr int kWarps = THREADS / 32;
  static constexpr int kTile = THREADS * ITEMS;
  int32_t sval[kTile];  // the staging tile; first the lane masks
  int warp_row[kWarps * kMaxRadix];  // counts, then offsets
  int tile_count[kMaxRadix];
  int local_start[kMaxRadix];
  int gofs[kMaxRadix];  // digit start, then global - local start
  int tile_prefix[kMaxRadix];
  int chunk_sum[2][kMaxRadix / 32];
  int tile_id;
  alignas(16) unsigned short sslot[kTile];
  unsigned char sdigit[kTile];
};

// CTAs an SM the register budget is set for.
constexpr int rank_ctas(int threads, int items) {
  return threads >= 256 ? (items >= 32 ? 2 : 3) : 4;
}

template <int THREADS, int ITEMS, bool LOOKBACK, typename Word>
__global__ void __launch_bounds__(THREADS, rank_ctas(THREADS, ITEMS))
rank_scatter_kernel(const int32_t* __restrict__ digsrc, int64_t n, int shift,
                    int bits, const int32_t* __restrict__ base,
                    LookBack lb, int64_t nblocks, Planes planes,
                    int nplanes, int32_t* __restrict__ dest_out) {
  constexpr int kWarps = THREADS / 32;
  constexpr int kTile = THREADS * ITEMS;
  constexpr int kChunks = kMaxRadix / 32;
  static_assert(kTile >= kWarps * kMaxRadix, "the lane masks live in sval");
  extern __shared__ __align__(16) unsigned char smem[];
  auto& sh = *reinterpret_cast<RankShared<THREADS, ITEMS>*>(smem);
  int* warp_row = sh.warp_row;
  int* tile_count = sh.tile_count;
  int* local_start = sh.local_start;
  int* gofs = sh.gofs;
  int* tile_prefix = sh.tile_prefix;
  int(*chunk_sum)[kChunks] = sh.chunk_sum;
  int32_t* sval = sh.sval;
  unsigned short* sslot = sh.sslot;
  unsigned char* sdigit = sh.sdigit;
  int& tile_id = sh.tile_id;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int radix = 1 << bits;
  const unsigned dmask = (unsigned)radix - 1u;
  if (LOOKBACK && tid == 0) tile_id = (int)atomicAdd(lb.counter, 1u);
  for (int i = tid; i < kWarps * radix; i += THREADS) {
    warp_row[i] = 0;
    reinterpret_cast<unsigned*>(sval)[i] = 0u;
  }
  if (LOOKBACK)
    for (int d = tid; d < radix; d += THREADS) gofs[d] = lb.counts[d];
  __syncthreads();
  const int64_t t = LOOKBACK ? (int64_t)tile_id : (int64_t)blockIdx.x;
  const int64_t tile_start = t * kTile;
  const int count = (int)(n - tile_start < kTile ? n - tile_start : kTile);

  // 1. the warp's 32 * ITEMS consecutive keys, a coalesced round at a time
  const int first = warp * 32 * ITEMS + lane;
  int32_t key[ITEMS];
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int li = first + r * 32;
    key[r] = li < count ? digsrc[tile_start + li] : 0;
  }

  // 2. in-warp stable ranks into the warp's own counter row
  int* row = warp_row + warp * radix;
  // the lanes of each digit, one bit a lane, in the staging tile's space
  unsigned* mask = reinterpret_cast<unsigned*>(sval) + warp * radix;
  const unsigned lower_lanes = (1u << lane) - 1u;
  int slot[ITEMS];
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const bool valid = first + r * 32 < count;
    const unsigned d = ((unsigned)key[r] >> shift) & dmask;
    // a round whose lanes share one digit (sorted or constant keys) skips
    // the lane masks, on which all 32 lanes would contend; the valid lanes
    // are a prefix of the warp, so lane 0 is one of them.  (Every lane
    // takes part in the shuffle: none may skip it.)
    const unsigned d0 = __shfl_sync(0xFFFFFFFFu, d, 0);
    const bool uniform = __all_sync(0xFFFFFFFFu, !valid || d == d0);
    unsigned* m = mask + d;
    unsigned peers;
    if (uniform) {
      peers = __ballot_sync(0xFFFFFFFFu, valid);
    } else {
      if (valid) atomicOr(m, 1u << lane);
      __syncwarp();
      peers = valid ? *m : 0u;
    }
    const int below = __popc(peers & lower_lanes);
    const int before = valid ? row[d] : 0;
    __syncwarp();
    if (valid && below == 0) {
      row[d] = before + __popc(peers);
      if (!uniform) *m = 0u;
    }
    __syncwarp();
    slot[r] = before + below;
  }
  __syncthreads();

  // 3. per digit: each warp's offset in the tile, the tile's count, and in
  //    look-back mode the aggregate, published at once
  for (int d = tid; d < radix; d += THREADS) {
    int run = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_row[w * radix + d];
      warp_row[w * radix + d] = run;
      run += c;
    }
    tile_count[d] = run;
    if (LOOKBACK) {
      using S = StatusWord<Word>;
      Word* st = static_cast<Word*>(lb.status);
      S::store(&st[t * radix + d], (t == 0 ? S::kPrefix : S::kAggregate) |
                                       (Word)run);
    }
  }
  __syncthreads();

  // 4. look back (one thread a digit), and scan the tile's counts (and in
  //    look-back mode the pass's totals) over the digits, 32 at a time
  if (LOOKBACK) {
    using S = StatusWord<Word>;
    Word* st = static_cast<Word*>(lb.status);
    for (int d = tid; d < radix; d += THREADS) {
      Word prefix = 0;
      if (t > 0) {
        for (int64_t p = t - 1;; --p) {
          Word w;
          do {
            w = S::load(&st[p * radix + d]);
          } while (S::flag(w) == 0);
          prefix += S::value(w);
          if (S::flag(w) == 2) break;
        }
        S::store(&st[t * radix + d],
                 S::kPrefix | (prefix + (Word)tile_count[d]));
      }
      tile_prefix[d] = (int)prefix;
    }
  }
  const int nchunks = (radix + 31) >> 5;
  for (int c = warp; c < nchunks; c += kWarps) {
    const int d = c * 32 + lane;
    const int a = d < radix ? tile_count[d] : 0;
    const int g = (LOOKBACK && d < radix) ? gofs[d] : 0;
    int ia = a, ig = g;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int ya = __shfl_up_sync(0xFFFFFFFFu, ia, o);
      const int yg = __shfl_up_sync(0xFFFFFFFFu, ig, o);
      if (lane >= o) {
        ia += ya;
        ig += yg;
      }
    }
    if (d < radix) {
      local_start[d] = ia - a;
      if (LOOKBACK) gofs[d] = ig - g;
    }
    if (lane == 31) {
      chunk_sum[0][c] = ia;
      chunk_sum[1][c] = ig;
    }
  }
  __syncthreads();
  for (int d = tid; d < radix; d += THREADS) {
    int add_l = 0, add_g = 0;
    for (int c = 0; c < (d >> 5); ++c) {
      add_l += chunk_sum[0][c];
      add_g += chunk_sum[1][c];
    }
    const int ls = local_start[d] + add_l;
    local_start[d] = ls;
    int gb;
    if (LOOKBACK) {
      gb = gofs[d] + add_g + tile_prefix[d];
      if (lb.base_out != nullptr) lb.base_out[(int64_t)d * nblocks + t] = gb;
    } else {
      gb = base[(int64_t)d * nblocks + t];
    }
    gofs[d] = gb - ls;  // slot i of digit d goes to gofs[d] + i
  }
  __syncthreads();

  // 5. every element's slot in the digit-sorted tile
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int li = first + r * 32;
    if (li < count) {
      const unsigned d = ((unsigned)key[r] >> shift) & dmask;
      const int s = local_start[d] + warp_row[warp * radix + d] + slot[r];
      slot[r] = s;
      sslot[li] = (unsigned short)s;
      sdigit[s] = (unsigned char)d;
      if (dest_out != nullptr) dest_out[tile_start + li] = gofs[d] + s;
    }
  }
  __syncthreads();

  // 6. per plane: stage in slot order, then write each digit's run
  const bool whole = count == kTile;
  for (int p = 0; p < nplanes; ++p) {
    const int32_t* in = planes.in[p];
    int32_t* out = planes.out[p];
    if (in == digsrc) {
#pragma unroll
      for (int r = 0; r < ITEMS; ++r)
        if (first + r * 32 < count) sval[slot[r]] = key[r];
    } else if (whole && ((uintptr_t)in & 15u) == 0) {
      constexpr int kVecs = ITEMS / 4;  // 16-byte chunks a thread
      const int4* in4 = reinterpret_cast<const int4*>(in + tile_start);
      int4 v[kVecs];
#pragma unroll
      for (int j = 0; j < kVecs; ++j) v[j] = in4[j * THREADS + tid];
#pragma unroll
      for (int j = 0; j < kVecs; ++j) {
        const int c = j * THREADS + tid;
        const uint2 ss = *reinterpret_cast<const uint2*>(&sslot[4 * c]);
        sval[ss.x & 0xFFFFu] = v[j].x;
        sval[ss.x >> 16] = v[j].y;
        sval[ss.y & 0xFFFFu] = v[j].z;
        sval[ss.y >> 16] = v[j].w;
      }
    } else {
      for (int i = tid; i < count; i += THREADS)
        sval[sslot[i]] = in[tile_start + i];
    }
    __syncthreads();
    for (int i = tid; i < count; i += THREADS)
      out[gofs[sdigit[i]] + i] = sval[i];
    __syncthreads();
  }
}

template <int THREADS, int ITEMS, bool LOOKBACK, typename Word>
void launch_rank_scatter(const int32_t* digsrc, int64_t n, int shift,
                         int bits, const int32_t* base, const LookBack& lb,
                         int64_t nblocks, const Planes& planes, int nplanes,
                         int32_t* dest, cudaStream_t stream) {
  constexpr int kBytes = sizeof(RankShared<THREADS, ITEMS>);
  auto kernel = rank_scatter_kernel<THREADS, ITEMS, LOOKBACK, Word>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kBytes);
  kernel<<<(unsigned)nblocks, THREADS, kBytes, stream>>>(
      digsrc, n, shift, bits, base, lb, nblocks, planes, nplanes, dest);
}

// Dispatch on the tile shape; false if (tile, threads) is not compiled.
template <bool LOOKBACK, typename Word>
bool rank_scatter_shape(int tile, int threads, const int32_t* digsrc,
                        int64_t n, int shift, int bits, const int32_t* base,
                        const LookBack& lb, int64_t nblocks,
                        const Planes& planes, int nplanes, int32_t* dest,
                        cudaStream_t s) {
  if (threads == 256 && tile == 8192)
    launch_rank_scatter<256, 32, LOOKBACK, Word>(digsrc, n, shift, bits, base, lb, nblocks, planes, nplanes, dest, s);
  else if (threads == 256 && tile == 4096)
    launch_rank_scatter<256, 16, LOOKBACK, Word>(digsrc, n, shift, bits, base, lb, nblocks, planes, nplanes, dest, s);
  else if (threads == 256 && tile == 2048)
    launch_rank_scatter<256, 8, LOOKBACK, Word>(digsrc, n, shift, bits, base, lb, nblocks, planes, nplanes, dest, s);
  else if (threads == 128 && tile == 4096)
    launch_rank_scatter<128, 32, LOOKBACK, Word>(digsrc, n, shift, bits, base, lb, nblocks, planes, nplanes, dest, s);
  else if (threads == 128 && tile == 2048)
    launch_rank_scatter<128, 16, LOOKBACK, Word>(digsrc, n, shift, bits, base, lb, nblocks, planes, nplanes, dest, s);
  else
    return false;
  return true;
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

bool fill_planes(Planes& planes, const void* const* ins, void* const* outs,
                 int nplanes) {
  if (nplanes < 0 || nplanes > kMaxPlanes) return false;
  for (int p = 0; p < kMaxPlanes; ++p) {
    planes.in[p] = p < nplanes ? (const int32_t*)ins[p] : nullptr;
    planes.out[p] = p < nplanes ? (int32_t*)outs[p] : nullptr;
  }
  return true;
}

bool radix_ok(int radix) {
  return radix >= 2 && radix <= kMaxRadix && (radix & (radix - 1)) == 0;
}

int num_sms() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
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

// base: (R, nblocks) int32, digit-major.  ins/outs: host arrays of nplanes
// device pointers (nplanes <= rst_max_planes()).  dest may be null.
int rst_rank_scatter(const void* digsrc, long long n, int tile, int threads,
                     int shift, int radix, const void* base,
                     const void* const* ins, void* const* outs, int nplanes,
                     void* dest, void* stream) {
  Planes planes;
  if (!radix_ok(radix) || n <= 0 || n >= (1ll << 31) || shift < 0 ||
      shift > 31 || !fill_planes(planes, ins, outs, nplanes))
    return (int)cudaErrorInvalidValue;
  const LookBack none = {nullptr, nullptr, nullptr, nullptr};
  if (!rank_scatter_shape<false, unsigned>(
          tile, threads, (const int32_t*)digsrc, n, shift, radix_bits(radix),
          (const int32_t*)base, none, (n + tile - 1) / tile, planes, nplanes,
          (int32_t*)dest, (cudaStream_t)stream))
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Digit counts of every pass: plane x0 carries passes0 passes (rows 0 ..
// passes0 - 1 of out), x1, if passes1 > 0, the next passes1.  out: (passes0
// + passes1, radix) int32, zeroed here on `stream` before the launch.
int rst_pass_histograms(const void* x0, int passes0, const void* x1,
                        int passes1, long long n, int radix, void* out,
                        void* stream) {
  const int bits = radix_bits(radix);
  if (!radix_ok(radix) || n <= 0 || n >= (1ll << 31) || passes0 < 1 ||
      passes1 < 0 || (uintptr_t)x0 % 4 || (passes1 > 0 && (uintptr_t)x1 % 4) ||
      (passes0 - 1) * bits > 31 || (passes1 - 1) * bits > 31)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int rows = passes0 + passes1;
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)rows * radix * 4, s);
  if (e != cudaSuccess) return (int)e;
  const HistPlanes hp = {{(const int32_t*)x0, (const int32_t*)x1},
                         {passes0, passes1},
                         {0, passes0}};
  const long long per_cta = (long long)kHistWarps * 32 * kHistUnroll * 4;
  long long ctas = (n + per_cta - 1) / per_cta;
  const long long most = 3ll * num_sms();
  if (ctas > most) ctas = most;
  const dim3 grid((unsigned)ctas, passes1 > 0 ? 2u : 1u);
  pass_histograms_kernel<<<grid, kHistThreads, 0, s>>>(hp, n, bits,
                                                        (int32_t*)out);
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
// null.  dest may be null.
int rst_onesweep_pass(const void* digsrc, long long n, int tile, int threads,
                      int shift, int radix, const void* counts, void* scratch,
                      long long scratch_bytes, const void* const* ins,
                      void* const* outs, int nplanes, void* dest,
                      void* base_out, void* stream) {
  Planes planes;
  if (!radix_ok(radix) || n <= 0 || n >= (1ll << 31) || shift < 0 ||
      shift > 31 || tile <= 0 || (uintptr_t)scratch % 16 ||
      scratch_bytes < onesweep_pass_bytes(n, tile, radix) ||
      !fill_planes(planes, ins, outs, nplanes))
    return (int)cudaErrorInvalidValue;
  const LookBack lb = {(const int32_t*)counts, (char*)scratch + 16,
                       (unsigned*)scratch, (int32_t*)base_out};
  const int32_t* ds = (const int32_t*)digsrc;
  const long long nblocks = (n + tile - 1) / tile;
  const int bits = radix_bits(radix);
  cudaStream_t s = (cudaStream_t)stream;
  const bool ok =
      n < (1ll << 30)
          ? rank_scatter_shape<true, unsigned>(tile, threads, ds, n, shift,
                                               bits, nullptr, lb, nblocks,
                                               planes, nplanes,
                                               (int32_t*)dest, s)
          : rank_scatter_shape<true, unsigned long long>(
                tile, threads, ds, n, shift, bits, nullptr, lb, nblocks,
                planes, nplanes, (int32_t*)dest, s);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
