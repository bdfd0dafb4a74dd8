// Radix-pass kernels for NVIDIA Hopper (sm_90a), bound to Python with ctypes.
//
// One stable LSD radix pass over int32 planes is three launches:
//
//   digit_histogram  per-tile digit counts, written digit-major (R, B)
//   exclusive_scan   exclusive prefix sum of the flat (R * B) counts; the
//                    digit-major order is what makes the scatter stable
//                    (one single-pass launch after a memset of its scratch)
//   rank_scatter     per-tile stable rank of every element, then a scatter
//                    of the digit plane and every payload plane through a
//                    shared-memory staging tile
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

// ---------------------------------------------------------- rank + scatter
//
// Replaces radix_sort_tpu/ops/pallas_radix.py:rank_pass (_rank_kernel) with
// the XLA scatter of ops/ranking.py:apply_destinations after it, and
// radix_sort_tpu/ops/pallas_stream.py:_radix_pass (_pass_kernel) with its
// XLA epilogue _boundary_fixup.  One CTA owns one tile of THREADS * ITEMS
// elements:
//
//   1. rank: ITEMS rounds of THREADS elements in element order.  Inside a
//      warp, __match_any_sync groups the lanes that share a digit and the
//      popcount of the lower lanes is the in-warp rank; per-warp digit
//      counts are scanned across warps in shared memory and added to the
//      running per-digit count of earlier rounds.  That is the stable rank
//      of the element among equal digits of its tile.
//   2. the tile's digit counts are scanned into local digit starts, and
//      every element gets a slot in a digit-sorted copy of the tile.
//   3. per plane: stage the tile in shared memory in slot order, then
//      write slot i to base[b, d] + (i - local_start[d]).  Neighbouring
//      threads write neighbouring addresses inside each digit's run, so
//      the scatter is coalesced run by run instead of element by element.
//
// Bound by bytes: every plane is read once and written once per pass
// (8 bytes an element and plane); the digit plane is read once more when
// it is not also moved.  Each tile writes every element it owns, so there
// are no boundary rows to repair, unlike the TPU kernel.
template <int THREADS, int ITEMS>
__global__ void __launch_bounds__(THREADS)
rank_scatter_kernel(const int32_t* __restrict__ digsrc, int64_t n, int shift,
                    int radix, const int32_t* __restrict__ base,
                    int64_t nblocks, Planes planes, int nplanes,
                    int32_t* __restrict__ dest_out) {
  constexpr int kWarps = THREADS / 32;
  constexpr int kTile = THREADS * ITEMS;
  __shared__ int warp_cnt[kWarps * kMaxRadix];
  __shared__ int warp_off[kWarps * kMaxRadix];
  __shared__ int running[kMaxRadix];
  __shared__ int local_start[kMaxRadix];
  __shared__ int gbase[kMaxRadix];
  __shared__ unsigned char sdigit[kTile];
  __shared__ int32_t sval[kTile];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t tile_start = (int64_t)blockIdx.x * kTile;
  const int count = (int)(n - tile_start < kTile ? n - tile_start : kTile);
  const unsigned dmask = (unsigned)radix - 1u;
  const unsigned lower_lanes = (1u << lane) - 1u;

  for (int d = tid; d < radix; d += THREADS) {
    gbase[d] = base[(int64_t)d * nblocks + blockIdx.x];
    running[d] = 0;
  }
  for (int i = tid; i < kWarps * radix; i += THREADS) warp_cnt[i] = 0;
  __syncthreads();

  int32_t key[ITEMS];
  unsigned dig[ITEMS];
  int slot[ITEMS];
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int li = r * THREADS + tid;
    const bool valid = li < count;
    const int32_t k = valid ? digsrc[tile_start + li] : 0;
    // Masked lanes take a digit no real lane has, so they only match
    // each other and never touch the counters.
    const unsigned d = valid ? (((unsigned)k >> shift) & dmask) : 0xFFFFFFFFu;
    key[r] = k;
    dig[r] = d;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
    const int lower = __popc(peers & lower_lanes);
    if (valid && lower == 0) warp_cnt[warp * radix + d] = __popc(peers);
    __syncthreads();
    for (int dd = tid; dd < radix; dd += THREADS) {
      int run = running[dd];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int c = warp_cnt[w * radix + dd];
        warp_off[w * radix + dd] = run;
        warp_cnt[w * radix + dd] = 0;
        run += c;
      }
      running[dd] = run;
    }
    __syncthreads();
    slot[r] = valid ? warp_off[warp * radix + d] + lower : 0;
  }

  // Local digit starts: warp 0 scans the tile's digit counts 32 at a time.
  if (warp == 0) {
    unsigned carry = 0;
    for (int off = 0; off < radix; off += 32) {
      const int dd = off + lane;
      const unsigned v = dd < radix ? (unsigned)running[dd] : 0u;
      unsigned incl = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        unsigned y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
        if (lane >= o) incl += y;
      }
      if (dd < radix) local_start[dd] = (int)(carry + incl - v);
      carry += __shfl_sync(0xFFFFFFFFu, incl, 31);
    }
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int li = r * THREADS + tid;
    if (li < count) {
      const unsigned d = dig[r];
      if (dest_out != nullptr) dest_out[tile_start + li] = gbase[d] + slot[r];
      slot[r] += local_start[d];
      sdigit[slot[r]] = (unsigned char)d;
    }
  }
  __syncthreads();

  for (int p = 0; p < nplanes; ++p) {
    const int32_t* in = planes.in[p];
    int32_t* out = planes.out[p];
    const bool is_digit_plane = in == digsrc;
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      const int li = r * THREADS + tid;
      if (li < count) sval[slot[r]] = is_digit_plane ? key[r] : in[tile_start + li];
    }
    __syncthreads();
    for (int i = tid; i < count; i += THREADS) {
      const int d = sdigit[i];
      out[(int64_t)gbase[d] + (i - local_start[d])] = sval[i];
    }
    __syncthreads();
  }
}

template <int THREADS, int ITEMS>
void launch_rank_scatter(const int32_t* digsrc, int64_t n, int shift,
                         int radix, const int32_t* base, int64_t nblocks,
                         const Planes& planes, int nplanes, int32_t* dest,
                         cudaStream_t stream) {
  rank_scatter_kernel<THREADS, ITEMS><<<(unsigned)nblocks, THREADS, 0, stream>>>(
      digsrc, n, shift, radix, base, nblocks, planes, nplanes, dest);
}

bool radix_ok(int radix) {
  return radix >= 2 && radix <= kMaxRadix && (radix & (radix - 1)) == 0;
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
  if (!radix_ok(radix) || n <= 0 || shift < 0 || shift > 31 || nplanes < 0 ||
      nplanes > kMaxPlanes)
    return (int)cudaErrorInvalidValue;
  Planes planes;
  for (int p = 0; p < kMaxPlanes; ++p) {
    planes.in[p] = p < nplanes ? (const int32_t*)ins[p] : nullptr;
    planes.out[p] = p < nplanes ? (int32_t*)outs[p] : nullptr;
  }
  const long long nblocks = (n + tile - 1) / tile;
  const int32_t* ds = (const int32_t*)digsrc;
  const int32_t* b = (const int32_t*)base;
  int32_t* d = (int32_t*)dest;
  cudaStream_t s = (cudaStream_t)stream;
  if (threads == 256 && tile == 4096) {
    launch_rank_scatter<256, 16>(ds, n, shift, radix, b, nblocks, planes, nplanes, d, s);
  } else if (threads == 256 && tile == 2048) {
    launch_rank_scatter<256, 8>(ds, n, shift, radix, b, nblocks, planes, nplanes, d, s);
  } else if (threads == 128 && tile == 4096) {
    launch_rank_scatter<128, 32>(ds, n, shift, radix, b, nblocks, planes, nplanes, d, s);
  } else if (threads == 128 && tile == 2048) {
    launch_rank_scatter<128, 16>(ds, n, shift, radix, b, nblocks, planes, nplanes, d, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
