// Radix-pass kernels for NVIDIA Hopper (sm_90a), bound to Python with ctypes.
//
// One stable LSD radix pass over int32 planes is three launches:
//
//   digit_histogram  per-tile digit counts, written digit-major (R, B)
//   exclusive_scan   exclusive prefix sum of the flat (R * B) counts; the
//                    digit-major order is what makes the scatter stable
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

// Exclusive scan across one CTA of THREADS threads.  `scratch` holds at
// least THREADS / 32 + 1 words of shared memory; the CTA total lands in
// scratch[THREADS / 32].  Every thread of the CTA must call it.  Unsigned
// arithmetic gives defined wraparound, the same as an int32 cumsum.
template <int THREADS>
__device__ unsigned block_exclusive_scan(unsigned v, unsigned* scratch) {
  constexpr int kWarps = THREADS / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    unsigned y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    unsigned s = lane < kWarps ? scratch[lane] : 0u;
    unsigned si = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      unsigned y = __shfl_up_sync(0xFFFFFFFFu, si, o);
      if (lane >= o) si += y;
    }
    if (lane < kWarps) scratch[lane] = si - s;
    if (lane == kWarps - 1) scratch[kWarps] = si;
  }
  __syncthreads();
  unsigned r = incl - v + scratch[warp];
  __syncthreads();  // scratch may be reused by the caller right away
  return r;
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
// Replaces radix_sort_tpu/ops/pallas_radix.py:exclusive_scan (_scan_kernel).
// The TPU kernel carried a running sum across a sequential grid; CTAs run
// in no order here, so the scan is reduce -> scan the per-chunk partials in
// one CTA -> rescan each chunk with its partial added.  Bound by bytes: it
// reads the input twice and writes it once, which is small beside a radix
// pass (the input is the (R * B) histogram, R * 4 bytes per tile).
constexpr int kScanThreads = 256;
constexpr int kScanItems = 16;
constexpr int kScanChunk = kScanThreads * kScanItems;

__global__ void scan_reduce_kernel(const int32_t* __restrict__ x, int64_t n,
                                   int32_t* __restrict__ partials) {
  __shared__ unsigned scratch[kScanThreads / 32 + 1];
  const int64_t start = (int64_t)blockIdx.x * kScanChunk;
  unsigned s = 0;
  for (int i = threadIdx.x; i < kScanChunk; i += kScanThreads) {
    const int64_t g = start + i;
    if (g < n) s += (unsigned)x[g];
  }
  block_exclusive_scan<kScanThreads>(s, scratch);
  if (threadIdx.x == 0) partials[blockIdx.x] = (int32_t)scratch[kScanThreads / 32];
}

// One CTA scans all partials in place, kScanThreads at a time with a carry.
__global__ void scan_partials_kernel(int32_t* __restrict__ partials,
                                     int64_t nparts) {
  __shared__ unsigned scratch[kScanThreads / 32 + 1];
  unsigned carry = 0;
  for (int64_t off = 0; off < nparts; off += kScanThreads) {
    const int64_t g = off + threadIdx.x;
    const unsigned v = g < nparts ? (unsigned)partials[g] : 0u;
    const unsigned e = block_exclusive_scan<kScanThreads>(v, scratch);
    const unsigned total = scratch[kScanThreads / 32];
    if (g < nparts) partials[g] = (int32_t)(e + carry);
    carry += total;
    __syncthreads();
  }
}

__global__ void scan_apply_kernel(const int32_t* __restrict__ x, int64_t n,
                                  const int32_t* __restrict__ partials,
                                  int32_t* __restrict__ out) {
  __shared__ unsigned scratch[kScanThreads / 32 + 1];
  const int64_t start = (int64_t)blockIdx.x * kScanChunk;
  unsigned carry = (unsigned)partials[blockIdx.x];
  // kScanItems rounds of kScanThreads consecutive elements: coalesced loads.
  for (int r = 0; r < kScanItems; ++r) {
    const int64_t g = start + (int64_t)r * kScanThreads + threadIdx.x;
    const unsigned v = g < n ? (unsigned)x[g] : 0u;
    const unsigned e = block_exclusive_scan<kScanThreads>(v, scratch);
    const unsigned total = scratch[kScanThreads / 32];
    if (g < n) out[g] = (int32_t)(e + carry);
    carry += total;
    __syncthreads();
  }
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

int rst_scan_chunk() { return kScanChunk; }

// `partials` is scratch of ceil(n / rst_scan_chunk()) int32.
int rst_exclusive_scan(const void* x, long long n, void* out, void* partials,
                       void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const long long nparts = (n + kScanChunk - 1) / kScanChunk;
  cudaStream_t s = (cudaStream_t)stream;
  scan_reduce_kernel<<<(unsigned)nparts, kScanThreads, 0, s>>>(
      (const int32_t*)x, n, (int32_t*)partials);
  scan_partials_kernel<<<1, kScanThreads, 0, s>>>((int32_t*)partials, nparts);
  scan_apply_kernel<<<(unsigned)nparts, kScanThreads, 0, s>>>(
      (const int32_t*)x, n, (const int32_t*)partials, (int32_t*)out);
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
