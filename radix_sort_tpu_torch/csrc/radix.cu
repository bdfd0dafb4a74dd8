// Radix-pass kernels for NVIDIA Hopper (sm_90a), bound to Python with ctypes.
//
// A sort (or a partition) is a onesweep LSD radix sort over int32 planes:
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

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxRadix = 256;
constexpr int kMaxPlanes = 16;

// The buffer sets of a sort's planes: IN (the planes the sort was given,
// never written), OUT (where the sort's result lands) and TMP.  A launch
// reads one set and writes another, as the plan says (Plan); with no plan
// it reads IN and writes OUT.
enum BufferSet { kIn = 0, kOut = 1, kTmp = 2, kSets = 3 };

struct Planes {
  int32_t* buf[kSets][kMaxPlanes];
};

// The digit plane (the key plane a pass takes its digit from) in each set;
// the same pointer in all three when it does not move (a partition's ids).
struct DigitPlanes {
  const void* buf[kSets];
};

// d.buf[set] by constant indices: a kernel parameter indexed at run time
// is copied to the stack.
__device__ __forceinline__ const void* digit_plane(const DigitPlanes& d,
                                                   int set) {
  return set == kIn ? d.buf[kIn] : set == kOut ? d.buf[kOut] : d.buf[kTmp];
}

// The image of a narrow key, the bits whose unsigned order is the key
// order: key ^ pos where the key's top bit is clear, key ^ neg where it is
// set.  Unsigned keys: (0, 0); signed: the sign bit both ways; floats: the
// sign bit, and every bit of a negative.
struct KeyKind {
  unsigned pos;
  unsigned neg;
};

// The element type of a key plane of KB bytes.
template <int KB>
struct KeyWord;
template <>
struct KeyWord<1> {
  using T = unsigned char;
};
template <>
struct KeyWord<2> {
  using T = unsigned short;
};
template <>
struct KeyWord<4> {
  using T = int32_t;
};

// The bits of a KB-byte key within a 32-bit word.
template <int KB>
constexpr unsigned kKeyMask = (KB == 4 ? 0u : 1u << (8 * KB % 32)) - 1u;

// raw: a KB-byte key, zero-extended.  An int32 word is its own image.
template <int KB>
__device__ __forceinline__ unsigned key_image(unsigned raw, KeyKind kk) {
  if constexpr (KB == 4) {
    return raw;
  } else {
    return raw ^ ((raw >> (8 * KB - 1)) ? kk.neg : kk.pos);
  }
}

template <int KB>
__device__ __forceinline__ unsigned key_unimage(unsigned img, KeyKind kk) {
  if constexpr (KB == 4) {
    return img;
  } else {
    return img ^ ((img >> (8 * KB - 1)) ? kk.pos : kk.neg);
  }
}

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
//   - The plan (Plan).  The host launches every pass of a sort; each CTA
//     first reads key 0's digit of every pass and that digit's total (warp
//     0, P lanes, while warp 1 takes the tile id), and a CTA of a filled pass
//     returns before it ranks, so the host never waits on the table.  It
//     chooses the buffer sets too: the passes that run ping-pong between
//     OUT and TMP so that the last writes OUT, and a sort that runs no
//     pass copies IN to OUT in its last launch.
//   - Tiles.  The sort's default, 8192 elements of 256 threads, takes
//     ~70 KB of shared memory (the lane masks share the staging tile's
//     space) and two CTAs an SM; it amortizes the per-tile barriers and
//     look-back over twice the elements of 4096 (1.32 against 1.49 ms a
//     u32 KV pass at 2^27: scripts/onesweep_probe.py).  4096-element
//     tiles keep three CTAs of 256 threads an SM in <= 85 registers; a
//     fourth (64 registers) was slower.
//   - A narrow key plane (KB = 1 or 2 bytes, the caller's own keys) is
//     read and moved at its own width, so a u8 KV pass moves 10 bytes an
//     element where a widened one moved 16 (f16: 12).  In a whole tile a
//     lane loads one 32-bit word, 4 or 2 consecutive keys, so a warp reads
//     128 consecutive bytes; shuffles then hand lane l of round r the key
//     of element r * 32 + l, the order the in-warp ranking is stable in,
//     and the key goes to its image in registers.  The ragged tile and a
//     plane that does not start on a 4-byte boundary load key by key.  The
//     key plane is staged through the tile's space at its own width and
//     written back as the caller's bits; payload planes stay int32.
//   - Registers, not shared memory, hold an 8192-key tile to two CTAs an
//     SM: three CTAs' 68 KB each fit the SM's 228 KB, but 32 keys and 32
//     slots a thread take 128 registers.  A narrow key keeps its images
//     4 or 2 to a register and its slots 2 to a register (a slot is below
//     2^16), and moves into the staging tile as its slot is found, so it
//     is not live in the scatter; its kernels run three CTAs of 8192 an
//     SM.  (The staging tile's shared memory stays 4 bytes a key: the
//     int32 payload is staged there.)
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

// The plan of a sort, decided on the card as the JAX engine decides it
// (radix_sort_tpu/ops/pallas_stream.py:572, max(totals) == padded): pass q
// is filled, and is the identity, when one digit holds every key, which is
// exactly when table[q][digit_q(key 0)] == n, key 0 being element 0 of
// the key plane pass q reads in IN (whether a pass is filled depends only
// on the multiset of keys, which every pass keeps).  Every CTA of every
// launch of the sort derives the whole plan from P loads of the table and
// at most two of key 0, so no launch waits on another and the host reads
// nothing.  Of the m passes that run, the k-th reads IN (k = 0) or what
// the one before it wrote, and writes OUT when m - 1 - k is even, else
// TMP: the last lands in OUT.  A filled pass returns after the prologue;
// when no pass runs (m = 0) the launch of the last pass copies IN to OUT,
// so a sort never hands back its input's storage.
constexpr int kMaxPasses = 64;  // 64-bit keys at radix 2

struct Plan {
  const int32_t* table;  // (P, R) digit totals of every pass; null: no plan
  const void* key0[2];   // the sort's key planes in IN: passes0 passes, rest
  int npasses;           // P
  int passes0;
  int pass;              // this launch's pass
};

// What one launch does, as the plan says, packed for one shared word.
enum PassMode { kSkip = 0, kRun = 1, kCopy = 2 };

__device__ __forceinline__ int pack_role(int mode, int src, int dst) {
  return mode | src << 2 | dst << 4;
}

// Warp-wide (every lane calls it): the launch's role, written by lane 0.
template <int KB>
__device__ __forceinline__ void plan_role(const Plan& pl, int64_t n,
                                          int bits, KeyKind kk, int lane,
                                          int* role) {
  using K = typename KeyWord<KB>::T;
  if (pl.table == nullptr) {
    if (lane == 0) *role = pack_role(kRun, kIn, kOut);
    return;
  }
  const unsigned dmask = (1u << bits) - 1u;
  unsigned long long run = 0ull;  // bit q: pass q runs
  for (int q0 = 0; q0 < pl.npasses; q0 += 32) {
    const int q = q0 + lane;
    bool runs = false;
    if (q < pl.npasses) {
      const bool second = q >= pl.passes0;  // a 64-bit key's high word
      const unsigned key =
          second ? (unsigned)static_cast<const int32_t*>(pl.key0[1])[0]
                 : key_image<KB>(
                       (unsigned)static_cast<const K*>(pl.key0[0])[0], kk);
      const int s = (second ? q - pl.passes0 : q) * bits;
      runs = pl.table[(int64_t)q * (dmask + 1u) + ((key >> s) & dmask)] !=
             (int32_t)n;
    }
    run |= (unsigned long long)__ballot_sync(0xFFFFFFFFu, runs) << q0;
  }
  if (lane != 0) return;
  const int p = pl.pass;
  const int m = __popcll(run);
  const int k = __popcll(run & ((1ull << p) - 1ull));
  // the destination of this pass, the k-th that runs, and of the one before
  const int dst = ((m - 1 - k) & 1) ? kTmp : kOut;
  const int prev = ((m - k) & 1) ? kTmp : kOut;
  if ((run >> p) & 1ull)
    *role = pack_role(kRun, k == 0 ? kIn : prev, dst);
  else if (m == 0 && p == pl.npasses - 1)
    *role = pack_role(kCopy, kIn, kOut);
  else
    *role = pack_role(kSkip, kIn, kIn);
}

// One CTA's tile of a plane, in to out: 16-byte vectors where the tile is
// whole and both sides aligned.
template <typename T, int THREADS, int TILE>
__device__ __forceinline__ void copy_tile(const T* __restrict__ in,
                                          T* __restrict__ out, int count,
                                          int tid) {
  constexpr int kVecs = TILE * (int)sizeof(T) / 16;
  if (count == TILE && (((uintptr_t)in | (uintptr_t)out) & 15u) == 0) {
    const int4* i4 = reinterpret_cast<const int4*>(in);
    int4* o4 = reinterpret_cast<int4*>(out);
    constexpr int kPer = (kVecs + THREADS - 1) / THREADS;
    int4 v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (j * THREADS + tid < kVecs) v[j] = i4[j * THREADS + tid];
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (j * THREADS + tid < kVecs) o4[j * THREADS + tid] = v[j];
  } else {
    for (int i = tid; i < count; i += THREADS) out[i] = in[i];
  }
}

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
  int role;  // plan_role's
  alignas(16) unsigned short sslot[kTile];
  unsigned char sdigit[kTile];
};

// CTAs an SM the register budget is set for: a narrow key plane packs its
// keys and slots, so 8192 of them fit three CTAs an SM.
constexpr int rank_ctas(int threads, int items, int key_bytes) {
  return threads >= 256 ? (items >= 32 && key_bytes == 4 ? 2 : 3) : 4;
}

// Round r's key image from the packed registers of step 1.
template <int KB, int N>
__device__ __forceinline__ unsigned packed_key(const unsigned (&kw)[N],
                                               int r) {
  constexpr int kPer = 4 / KB;
  return (kw[r / kPer] >> (8 * KB * (r % kPer))) & kKeyMask<KB>;
}

// KB: the bytes of a key of the digit source (1, 2 or 4).
template <int THREADS, int ITEMS, bool LOOKBACK, typename Word, int KB>
__global__ void __launch_bounds__(THREADS, rank_ctas(THREADS, ITEMS, KB))
rank_scatter_kernel(DigitPlanes digit, int64_t n, int shift, int bits,
                    KeyKind kk, const int32_t* __restrict__ base,
                    LookBack lb, Plan plan, int64_t nblocks, Planes planes,
                    int nplanes, int32_t* __restrict__ dest_out) {
  using K = typename KeyWord<KB>::T;
  constexpr int kWarps = THREADS / 32;
  constexpr int kTile = THREADS * ITEMS;
  constexpr int kChunks = kMaxRadix / 32;
  static_assert(kTile >= kWarps * kMaxRadix, "the lane masks live in sval");
  static_assert(ITEMS % (4 / KB) == 0, "a round of words fills whole rounds");
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
  // warp 1 takes the tile id while warp 0 reads the plan: the two round
  // trips overlap
  if (LOOKBACK && tid == 32) tile_id = (int)atomicAdd(lb.counter, 1u);
  if (warp == 0) plan_role<KB>(plan, n, bits, kk, lane, &sh.role);
  for (int i = tid; i < kWarps * radix; i += THREADS) {
    warp_row[i] = 0;
    reinterpret_cast<unsigned*>(sval)[i] = 0u;
  }
  if (LOOKBACK)
    for (int d = tid; d < radix; d += THREADS) gofs[d] = lb.counts[d];
  __syncthreads();
  // The sets this launch reads and writes (plan_role's), read from shared
  // memory where they are used, so that no register holds them through
  // the ranking (the 8192-key int32 instance has none to spare).
  auto role_now = [&]() {
    return *reinterpret_cast<volatile int*>(&sh.role);
  };
  auto src_of = [](int role) { return (role >> 2) & 3; };
  auto dst_of = [](int role) { return role >> 4; };
  const int role = role_now();
  if ((role & 3) == kSkip) return;  // a filled pass
  const K* digsrc = static_cast<const K*>(digit_plane(digit, src_of(role)));
  const int64_t t = LOOKBACK ? (int64_t)tile_id : (int64_t)blockIdx.x;
  const int64_t tile_start = t * kTile;
  const int count = (int)(n - tile_start < kTile ? n - tile_start : kTile);
  if ((role & 3) == kCopy) {  // no pass runs: IN to OUT, at each width
    for (int p = 0; p < nplanes; ++p) {
      const int32_t* in = planes.buf[src_of(role)][p];
      int32_t* out = planes.buf[dst_of(role)][p];
      if (KB < 4 && (const void*)in == digsrc)
        copy_tile<K, THREADS, kTile>(reinterpret_cast<const K*>(in) +
                                         tile_start,
                                     reinterpret_cast<K*>(out) + tile_start,
                                     count, tid);
      else
        copy_tile<int32_t, THREADS, kTile>(in + tile_start, out + tile_start,
                                           count, tid);
    }
    return;
  }

  // 1. the warp's 32 * ITEMS consecutive keys, a coalesced round at a
  //    time.  A narrow key is kept as its image, kPer to a register (round
  //    r in bits 8 * KB * (r % kPer) of kw[r / kPer]), and its slot below
  //    in a 16-bit half: registers that let three CTAs of 8192 keys share
  //    an SM.
  constexpr int kPer = 4 / KB;
  constexpr int kSlotPer = KB == 4 ? 1 : 2;
  const int first = warp * 32 * ITEMS + lane;
  unsigned kw[ITEMS / kPer];
  if constexpr (KB == 4) {
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      const int li = first + r * 32;
      kw[r] = li < count ? (unsigned)digsrc[tile_start + li] : 0u;
    }
  } else if (count == kTile && ((uintptr_t)digsrc & 3u) == 0) {
    // a word of kPer keys a lane; round r takes element r * 32 + lane from
    // lane (r % kPer) * 32 / kPer + lane / kPer of load r / kPer
    const unsigned* w = reinterpret_cast<const unsigned*>(
        digsrc + tile_start + warp * 32 * ITEMS);
    const int at = (lane % kPer) * 8 * KB;
#pragma unroll
    for (int q = 0; q < ITEMS / kPer; ++q) {
      const unsigned word = w[q * 32 + lane];
      kw[q] = 0u;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const unsigned src =
            __shfl_sync(0xFFFFFFFFu, word, j * (32 / kPer) + lane / kPer);
        kw[q] |= key_image<KB>((src >> at) & kKeyMask<KB>, kk)
                 << (8 * KB * j);
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < ITEMS / kPer; ++q) kw[q] = 0u;
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      const int li = first + r * 32;
      if (li < count)
        kw[r / kPer] |= key_image<KB>(digsrc[tile_start + li], kk)
                        << (8 * KB * (r % kPer));
    }
  }

  // 2. in-warp stable ranks into the warp's own counter row
  int* row = warp_row + warp * radix;
  // the lanes of each digit, one bit a lane, in the staging tile's space
  unsigned* mask = reinterpret_cast<unsigned*>(sval) + warp * radix;
  const unsigned lower_lanes = (1u << lane) - 1u;
  int slot[ITEMS / kSlotPer];
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const bool valid = first + r * 32 < count;
    const unsigned d = (packed_key<KB>(kw, r) >> shift) & dmask;
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
    if constexpr (kSlotPer == 1)
      slot[r] = before + below;
    else  // a slot is below kTile <= 2^16
      slot[r / 2] = r % 2 ? slot[r / 2] | (before + below) << 16
                          : before + below;
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

  // 5. every element's slot in the digit-sorted tile; a narrow key plane
  //    that moves is staged here at its own width, as the caller's bits
  bool key_moved = false;
  if constexpr (KB < 4) {
    const int r = role_now();
    for (int p = 0; p < nplanes; ++p)
      key_moved |= (const void*)planes.buf[src_of(r)][p] ==
                   digit_plane(digit, src_of(r));
  }
  K* skey = reinterpret_cast<K*>(sval);
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int li = first + r * 32;
    if (li < count) {
      const unsigned k = packed_key<KB>(kw, r);
      const unsigned d = (k >> shift) & dmask;
      int below;
      if constexpr (kSlotPer == 1)
        below = slot[r];
      else
        below = (int)(((unsigned)slot[r / 2] >> (16 * (r % 2))) & 0xFFFFu);
      const int s = local_start[d] + warp_row[warp * radix + d] + below;
      if constexpr (kSlotPer == 1) slot[r] = s;
      sslot[li] = (unsigned short)s;
      sdigit[s] = (unsigned char)d;
      if constexpr (KB < 4)
        if (key_moved) skey[s] = (K)key_unimage<KB>(k, kk);
      if (dest_out != nullptr) dest_out[tile_start + li] = gofs[d] + s;
    }
  }
  __syncthreads();

  // 6. per plane: stage in slot order, then write each digit's run (the
  //    narrow key plane, staged already, first)
  if constexpr (KB < 4) {
    if (key_moved) {
      const int r = role_now();
      for (int p = 0; p < nplanes; ++p) {
        if ((const void*)planes.buf[src_of(r)][p] !=
            digit_plane(digit, src_of(r)))
          continue;
        K* kout = reinterpret_cast<K*>(planes.buf[dst_of(r)][p]);
        for (int i = tid; i < count; i += THREADS)
          kout[gofs[sdigit[i]] + i] = skey[i];
      }
      __syncthreads();
    }
  }
  const bool whole = count == kTile;
  for (int p = 0; p < nplanes; ++p) {
    const int r = role_now();
    const int32_t* in = planes.buf[src_of(r)][p];
    int32_t* out = planes.buf[dst_of(r)][p];
    if ((const void*)in == digit_plane(digit, src_of(r))) {
      if constexpr (KB < 4) {
        continue;
      } else {
#pragma unroll
        for (int r = 0; r < ITEMS; ++r)
          if (first + r * 32 < count) sval[slot[r]] = (int32_t)kw[r];
      }
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

// The arguments of one rank_scatter launch.
struct PassArgs {
  DigitPlanes digit;
  int64_t n;
  int shift;
  int bits;
  KeyKind kk;
  const int32_t* base;
  LookBack lb;
  Plan plan;
  int64_t nblocks;
  Planes planes;
  int nplanes;
  int32_t* dest;
};

// Whether once-a-device work (a kernel's attributes, a device property:
// both belong to a device) is still to do on the current device `dev`: bit
// dev of `done` is clear.  The caller sets the bit when the work is done,
// so two threads may both do it, which is harmless.  Devices past 63 do it
// every time.
bool todo_on_device(const std::atomic<unsigned long long>& done, int* dev) {
  cudaGetDevice(dev);
  return *dev < 0 || *dev >= 64 || !((done.load() >> *dev) & 1ull);
}

void mark_device(std::atomic<unsigned long long>& done, int dev) {
  if (dev >= 0 && dev < 64) done.fetch_or(1ull << dev);
}

template <int THREADS, int ITEMS, bool LOOKBACK, typename Word, int KB>
void launch_rank_scatter(const PassArgs& a, cudaStream_t stream) {
  constexpr int kBytes = sizeof(RankShared<THREADS, ITEMS>);
  auto kernel = rank_scatter_kernel<THREADS, ITEMS, LOOKBACK, Word, KB>;
  // once an instantiation and device, not at every launch
  static std::atomic<unsigned long long> attributes_set{0};
  int dev = 0;
  if (todo_on_device(attributes_set, &dev)) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kBytes);
    if constexpr (KB < 4)  // room for rank_ctas CTAs an SM
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
    mark_device(attributes_set, dev);
  }
  kernel<<<(unsigned)a.nblocks, THREADS, kBytes, stream>>>(
      a.digit, a.n, a.shift, a.bits, a.kk, a.base, a.lb, a.plan, a.nblocks,
      a.planes, a.nplanes, a.dest);
}

// The (tile, threads) shapes rank_scatter_shape dispatches on.
bool rank_shape_ok(int tile, int threads) {
  return (threads == 256 && (tile == 8192 || tile == 4096 || tile == 2048)) ||
         (threads == 128 && (tile == 4096 || tile == 2048));
}

// Dispatch on the tile shape; false if (tile, threads) is not compiled.
template <bool LOOKBACK, typename Word, int KB>
bool rank_scatter_shape(int tile, int threads, const PassArgs& a,
                        cudaStream_t s) {
  if (threads == 256 && tile == 8192)
    launch_rank_scatter<256, 32, LOOKBACK, Word, KB>(a, s);
  else if (threads == 256 && tile == 4096)
    launch_rank_scatter<256, 16, LOOKBACK, Word, KB>(a, s);
  else if (threads == 256 && tile == 2048)
    launch_rank_scatter<256, 8, LOOKBACK, Word, KB>(a, s);
  else if (threads == 128 && tile == 4096)
    launch_rank_scatter<128, 32, LOOKBACK, Word, KB>(a, s);
  else if (threads == 128 && tile == 2048)
    launch_rank_scatter<128, 16, LOOKBACK, Word, KB>(a, s);
  else
    return false;
  return true;
}

// Dispatch on the bytes of a key of the digit source; false if not 1, 2, 4.
template <bool LOOKBACK, typename Word>
bool rank_scatter_launch(int key_bytes, int tile, int threads,
                         const PassArgs& a, cudaStream_t s) {
  switch (key_bytes) {
    case 4:
      return rank_scatter_shape<LOOKBACK, Word, 4>(tile, threads, a, s);
    case 2:
      return rank_scatter_shape<LOOKBACK, Word, 2>(tile, threads, a, s);
    case 1:
      return rank_scatter_shape<LOOKBACK, Word, 1>(tile, threads, a, s);
  }
  return false;
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
// writes TMP.
bool fill_planes(Planes& planes, const void* const* ins, void* const* outs,
                 void* const* tmps, int nplanes) {
  if (nplanes < 0 || nplanes > kMaxPlanes) return false;
  const void* const* sets[kSets] = {ins, outs, tmps ? tmps : outs};
  for (int b = 0; b < kSets; ++b)
    for (int p = 0; p < kMaxPlanes; ++p)
      planes.buf[b][p] = p < nplanes ? (int32_t*)sets[b][p] : nullptr;
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
// OUT and TMP; tmps may be null.  digsrc: the digit plane in IN, OUT and
// TMP (OUT and TMP may be null with no plan).  dest may be null.  The
// plan: table (P = npasses rows of radix), null for none; passes0 and
// key0 (one or two key planes in IN) as in Plan; pass, this launch's row.
int rst_rank_scatter(const void* const* digsrc, long long n, int tile,
                     int threads, int shift, int radix, int key_bytes,
                     int kind, const void* base, const void* const* ins,
                     void* const* outs, void* const* tmps, int nplanes,
                     void* dest, const void* table, int npasses, int passes0,
                     int pass, const void* const* key0, void* stream) {
  PassArgs a;
  if (!radix_ok(radix) || n <= 0 || n >= (1ll << 31) || tile <= 0 ||
      !pass_key_ok(key_bytes, kind, shift, &a.kk) ||
      !fill_planes(a.planes, ins, outs, tmps, nplanes) ||
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
                      void* dest, void* base_out, const void* table,
                      int npasses, int passes0, int pass,
                      const void* const* key0, void* stream) {
  PassArgs a;
  if (!radix_ok(radix) || n <= 0 || n >= (1ll << 31) || tile <= 0 ||
      !pass_key_ok(key_bytes, kind, shift, &a.kk) ||
      (uintptr_t)scratch % 16 ||
      scratch_bytes < onesweep_pass_bytes(n, tile, radix) ||
      !fill_planes(a.planes, ins, outs, tmps, nplanes) ||
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
// the planes' sets as in rst_rank_scatter, any number of planes (tmps may
// be null when P is 1).  workspace: rst_sort_workspace_bytes(n, tile,
// radix, P, nplanes) bytes, 16-byte aligned; its first P * radix int32
// hold the pass table after the call.  launches[3] is set to the
// pass_histograms, look-back and base-table launches made.
int rst_sort_planes(long long n, int radix, int tile, int threads,
                    int key_bytes, int kind, const void* const* keys,
                    int passes0, int passes1, const void* const* ins,
                    void* const* outs, void* const* tmps, int nplanes,
                    int digit_moves, void* workspace,
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
      if (keys[w] != ins[w]) return (int)cudaErrorInvalidValue;
  } else if (passes1 > 0 || key_bytes != 4) {
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
  const int groups = nplanes > kMaxPlanes
                         ? (nplanes + kMaxPlanes - 1) / kMaxPlanes
                         : 1;
  PassArgs a;
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
                  outs ? outs + lo : nullptr, tmps ? tmps + lo : nullptr, k);
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
