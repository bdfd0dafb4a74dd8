// The radix pass kernel (rank + scatter, onesweep) and its launch, shared
// by radix.cu, which builds its instances with int32 planes (and a narrow
// key plane) and every entry point, and radix_wide.cu, which builds its
// instances with 8-byte planes.  The two units are compiled at once
// (_build.py); rank_scatter_wide is where one calls the other.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace rst {

constexpr int kMaxRadix = 256;
constexpr int kMaxPlanes = 16;

// The buffer sets of a sort's planes: IN (the planes the sort was given,
// never written), OUT (where the sort's result lands) and TMP.  A launch
// reads one set and writes another, as the plan says (Plan); with no plan
// it reads IN and writes OUT.
enum BufferSet { kIn = 0, kOut = 1, kTmp = 2, kSets = 3 };

// Each plane in each set.  An 8-byte plane (its bit in the launch's `wide`
// mask) is read and written through the same pointer as 8-byte elements.
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

// A look-back status word of 64 bits: {flags, count} (StatusWord).
constexpr unsigned long long kTileAggregate = 1ull << 32;
constexpr unsigned long long kTilePrefix = 2ull << 32;

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
//   - 8-byte payload planes: an int64, uint64 or float64
//     column rides the pass as it is, where it once went as two int32 word
//     planes, split by strided copies before the sort and interleaved back
//     after it (32 bytes a row of copies around the 16 of each pass).  The
//     launch's `wide` mask marks them, a bit a plane of its group, and an
//     8-byte plane counts as one against kMaxPlanes.  A launch with one
//     runs rank_scatter_wide_kernel, chosen on the host: its staging tile
//     holds 8-byte elements (~100 KB of shared memory at 8192 keys: two
//     CTAs an SM at every key width).  In a whole, aligned tile a thread
//     loads its rows by 16-byte vectors, two rows each, in two rounds of
//     ITEMS / 4 vectors (the registers one int32 plane's loads take),
//     stages each row at its slot, then writes each digit's run by 8-byte
//     stores: 16 bytes of DRAM a row and pass, as the two word planes, in
//     half their staging rounds and barriers.  (Staging the low and then
//     the high words in the 4-byte tile, stored at 8-byte stride, would
//     keep three CTAs an SM for narrow keys, but writes every L2 sector of
//     the output twice.)  A u32 key and an int64 payload at 2^27: 1.61
//     device-ms a pass, against 1.70 as two word planes and 1.32 for an
//     int32 payload (chip_smoke.py's onesweep_pass_wide row).
//     rank_scatter_kernel, with no 8-byte plane, is the same kernel, code,
//     shared memory and register budget as before; rank_scatter_wide_kernel
//     takes the mask as its last argument.  Its 45 instances are compiled
//     in radix_wide.cu, beside radix.cu at once (_build.py): in one unit
//     nvcc took 112 s against 61 s without them (on the NVIDIA H100
//     machine's host).
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
// more than the 48 KB a kernel may declare statically.  WIDE: the staging
// tile holds 8-byte elements.
template <int THREADS, int ITEMS, bool WIDE>
struct RankShared {
  static constexpr int kWarps = THREADS / 32;
  static constexpr int kTile = THREADS * ITEMS;
  // the staging tile, 8-byte aligned; first the lane masks
  int32_t sval[WIDE ? 2 * kTile : kTile];
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
// keys and slots, so 8192 of them fit three CTAs an SM, unless an 8-byte
// staging tile (wide) leaves shared memory for two.
constexpr int rank_ctas(int threads, int items, int key_bytes, bool wide) {
  return threads >= 256 ? (items >= 32 && (key_bytes == 4 || wide) ? 2 : 3)
                        : 4;
}

// Round r's key image from the packed registers of step 1.
template <int KB, int N>
__device__ __forceinline__ unsigned packed_key(const unsigned (&kw)[N],
                                               int r) {
  constexpr int kPer = 4 / KB;
  return (kw[r / kPer] >> (8 * KB * (r % kPer))) & kKeyMask<KB>;
}

// Stage one tile of an 8-byte plane (`in`: its first row) at the rows'
// slots of the digit-sorted tile: in a whole, aligned tile by 16-byte
// vectors, two rows each, in two rounds of ITEMS / 4 a thread.
template <int THREADS, int ITEMS>
__device__ __forceinline__ void stage_wide(const long long* __restrict__ in,
                                           long long* s8,
                                           const unsigned short* sslot,
                                           int count, bool whole, int tid) {
  if (whole && ((uintptr_t)in & 15u) == 0) {
    constexpr int kVecs = ITEMS / 4;  // 16-byte vectors a thread a round
    const longlong2* in2 = reinterpret_cast<const longlong2*>(in);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      longlong2 v[kVecs];
#pragma unroll
      for (int j = 0; j < kVecs; ++j)
        v[j] = in2[(h * kVecs + j) * THREADS + tid];
#pragma unroll
      for (int j = 0; j < kVecs; ++j) {
        const int c = (h * kVecs + j) * THREADS + tid;  // rows 2c, 2c + 1
        const unsigned ss = *reinterpret_cast<const unsigned*>(&sslot[2 * c]);
        s8[ss & 0xFFFFu] = v[j].x;
        s8[ss >> 16] = v[j].y;
      }
    }
  } else {
    for (int i = tid; i < count; i += THREADS) s8[sslot[i]] = in[i];
  }
}

// One CTA's tile: the body of both pass kernels below, whose parameters it
// reads in place.  KB: the bytes of a key of the digit source (1, 2 or 4).
// WIDE: some plane is 8 bytes an element, plane p if bit p of `wide` is set
// (read only when WIDE); an 8-byte plane is never the digit plane.
template <int THREADS, int ITEMS, bool LOOKBACK, typename Word, int KB,
          bool WIDE>
__device__ __forceinline__ void rank_scatter_tile(
    const DigitPlanes& digit, int64_t n, int shift, int bits,
    const KeyKind& kk, const int32_t* __restrict__ base, const LookBack& lb,
    const Plan& plan, int64_t nblocks, const Planes& planes, int nplanes,
    int32_t* __restrict__ dest_out, unsigned wide) {
  using K = typename KeyWord<KB>::T;
  constexpr int kWarps = THREADS / 32;
  constexpr int kTile = THREADS * ITEMS;
  constexpr int kChunks = kMaxRadix / 32;
  static_assert(kTile >= kWarps * kMaxRadix, "the lane masks live in sval");
  static_assert(ITEMS % (4 / KB) == 0, "a round of words fills whole rounds");
  static_assert(ITEMS % 4 == 0, "8-byte rows load two to a 16-byte vector");
  extern __shared__ __align__(16) unsigned char smem[];
  auto& sh = *reinterpret_cast<RankShared<THREADS, ITEMS, WIDE>*>(smem);
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
  // plane p moves 8 bytes an element (in the WIDE instance only)
  auto is_wide = [wide](int p) { return WIDE && ((wide >> p) & 1u) != 0u; };
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
      if (is_wide(p))
        copy_tile<long long, THREADS, kTile>(
            reinterpret_cast<const long long*>(in) + tile_start,
            reinterpret_cast<long long*>(out) + tile_start, count, tid);
      else if (KB < 4 && (const void*)in == digsrc)
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
      key_moved |= !is_wide(p) && (const void*)planes.buf[src_of(r)][p] ==
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
        if (is_wide(p) || (const void*)planes.buf[src_of(r)][p] !=
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
    if constexpr (WIDE) {
      if (is_wide(p)) {
        stage_wide<THREADS, ITEMS>(reinterpret_cast<const long long*>(in) +
                                       tile_start,
                                   reinterpret_cast<long long*>(sval), sslot,
                                   count, whole, tid);
        __syncthreads();
        long long* out8 = reinterpret_cast<long long*>(out);
        const long long* s8 = reinterpret_cast<const long long*>(sval);
        for (int i = tid; i < count; i += THREADS)
          out8[gofs[sdigit[i]] + i] = s8[i];
        __syncthreads();
        continue;
      }
    }
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

// The pass kernel: int32 planes (and a narrow key plane).
template <int THREADS, int ITEMS, bool LOOKBACK, typename Word, int KB>
__global__ void __launch_bounds__(THREADS,
                                  rank_ctas(THREADS, ITEMS, KB, false))
rank_scatter_kernel(DigitPlanes digit, int64_t n, int shift, int bits,
                    KeyKind kk, const int32_t* __restrict__ base,
                    LookBack lb, Plan plan, int64_t nblocks, Planes planes,
                    int nplanes, int32_t* __restrict__ dest_out) {
  rank_scatter_tile<THREADS, ITEMS, LOOKBACK, Word, KB, false>(
      digit, n, shift, bits, kk, base, lb, plan, nblocks, planes, nplanes,
      dest_out, 0u);
}

// The pass kernel's WIDE instance: plane p moves 8 bytes an element where
// bit p of `wide` is set.
template <int THREADS, int ITEMS, bool LOOKBACK, typename Word, int KB>
__global__ void __launch_bounds__(THREADS,
                                  rank_ctas(THREADS, ITEMS, KB, true))
rank_scatter_wide_kernel(DigitPlanes digit, int64_t n, int shift, int bits,
                         KeyKind kk, const int32_t* __restrict__ base,
                         LookBack lb, Plan plan, int64_t nblocks,
                         Planes planes, int nplanes,
                         int32_t* __restrict__ dest_out, unsigned wide) {
  rank_scatter_tile<THREADS, ITEMS, LOOKBACK, Word, KB, true>(
      digit, n, shift, bits, kk, base, lb, plan, nblocks, planes, nplanes,
      dest_out, wide);
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
  unsigned wide;  // bit p: plane p is 8 bytes an element
};

// Whether once-a-device work (a kernel's attributes, a device property:
// both belong to a device) is still to do on the current device `dev`: bit
// dev of `done` is clear.  The caller sets the bit when the work is done,
// so two threads may both do it, which is harmless.  Devices past 63 do it
// every time.
inline bool todo_on_device(const std::atomic<unsigned long long>& done, int* dev) {
  cudaGetDevice(dev);
  return *dev < 0 || *dev >= 64 || !((done.load() >> *dev) & 1ull);
}

inline void mark_device(std::atomic<unsigned long long>& done, int dev) {
  if (dev >= 0 && dev < 64) done.fetch_or(1ull << dev);
}

template <int THREADS, int ITEMS, bool LOOKBACK, typename Word, int KB,
          bool WIDE>
void launch_rank_scatter(const PassArgs& a, cudaStream_t stream) {
  constexpr int kBytes = sizeof(RankShared<THREADS, ITEMS, WIDE>);
  auto kernel = [] {
    if constexpr (WIDE)
      return rank_scatter_wide_kernel<THREADS, ITEMS, LOOKBACK, Word, KB>;
    else
      return rank_scatter_kernel<THREADS, ITEMS, LOOKBACK, Word, KB>;
  }();
  // once an instantiation and device, not at every launch
  static std::atomic<unsigned long long> attributes_set{0};
  int dev = 0;
  if (todo_on_device(attributes_set, &dev)) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kBytes);
    if constexpr (KB < 4 || WIDE)  // room for rank_ctas CTAs an SM
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
    mark_device(attributes_set, dev);
  }
  if constexpr (WIDE)
    kernel<<<(unsigned)a.nblocks, THREADS, kBytes, stream>>>(
        a.digit, a.n, a.shift, a.bits, a.kk, a.base, a.lb, a.plan,
        a.nblocks, a.planes, a.nplanes, a.dest, a.wide);
  else
    kernel<<<(unsigned)a.nblocks, THREADS, kBytes, stream>>>(
        a.digit, a.n, a.shift, a.bits, a.kk, a.base, a.lb, a.plan,
        a.nblocks, a.planes, a.nplanes, a.dest);
}

// Dispatch on the tile shape; false if (tile, threads) is not compiled.
template <bool LOOKBACK, typename Word, int KB, bool WIDE>
bool rank_scatter_shape(int tile, int threads, const PassArgs& a,
                        cudaStream_t s) {
  if (threads == 256 && tile == 8192)
    launch_rank_scatter<256, 32, LOOKBACK, Word, KB, WIDE>(a, s);
  else if (threads == 256 && tile == 4096)
    launch_rank_scatter<256, 16, LOOKBACK, Word, KB, WIDE>(a, s);
  else if (threads == 256 && tile == 2048)
    launch_rank_scatter<256, 8, LOOKBACK, Word, KB, WIDE>(a, s);
  else if (threads == 128 && tile == 4096)
    launch_rank_scatter<128, 32, LOOKBACK, Word, KB, WIDE>(a, s);
  else if (threads == 128 && tile == 2048)
    launch_rank_scatter<128, 16, LOOKBACK, Word, KB, WIDE>(a, s);
  else
    return false;
  return true;
}

// Dispatch on the bytes of a key of the digit source; false if not 1, 2, 4.
template <bool LOOKBACK, typename Word, bool WIDE>
bool rank_scatter_keyed(int key_bytes, int tile, int threads,
                        const PassArgs& a, cudaStream_t s) {
  switch (key_bytes) {
    case 4:
      return rank_scatter_shape<LOOKBACK, Word, 4, WIDE>(tile, threads, a, s);
    case 2:
      return rank_scatter_shape<LOOKBACK, Word, 2, WIDE>(tile, threads, a, s);
    case 1:
      return rank_scatter_shape<LOOKBACK, Word, 1, WIDE>(tile, threads, a, s);
  }
  return false;
}

// rank_scatter_wide_kernel's launch for `a` (a.wide != 0), in radix_wide.cu:
// false if the shape or key width is not compiled.  word64: 64-bit status
// words (n >= 2^30).
bool rank_scatter_wide(const PassArgs& a, bool lookback, bool word64,
                       int key_bytes, int tile, int threads,
                       cudaStream_t stream);

}  // namespace rst
