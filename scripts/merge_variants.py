"""Time the merge path's kernels and their design alternatives on one card.

    python3 scripts/merge_variants.py [--parent DIR] [--order 0,1,1,0,1,0]
                                      [--variants [NAME,...]] [--ptxas]

Each measurement runs in a fresh process started in one tree's root, which
imports that tree's ``radix_sort_tpu_torch`` and builds its kernels there.
It times, on keys made on the card from a seed:

  - ``tile_sort`` at 2^25 beside ``torch.sort`` of the tiles;
  - ``merge_level`` at levels 0 and 10 (the last) of a 2^25 sort and levels
    0 and 12 of a 2^27 sort;
  - a copy of the keys (``x.clone()``, the same 8 bytes a key as a merge
    level) at both sizes, the rate a level could reach;
  - ``sort(engine="merge")`` of u32 keys at 2^25 and 2^27 beside
    ``torch.sort``, and ``top_k`` at 2^25 with k = 2^24 under ``merge``;
  - on Range keys at 2^25 (each output tile one whole window):
    ``merge_level`` at levels 0 and 10, and ``sort(engine="merge")``.

Kernel times are device time (``chip_smoke.device_ms``: CUDA events
around 50 back-to-back calls queued behind ``torch.cuda._sleep``, divided
by 50, median of 3); sort times are one call's event time, median of 5
(``chip_smoke.time_ms``).  Trees, turns and timers are
``scripts/turns.py``'s.  Each tree checks ``tile_sort`` and both merge levels of 2^25 against their
plain versions bit for bit, and the sorts against ``torch.sort``.

``--parent DIR`` (a checkout of the parent commit, e.g. unpacked with
``git archive <commit> | tar -x -C build/parent``) adds the parent's tree,
and the parent (tree 0) and this tree (tree 1) run in turns in ``--order``.
``--variants`` adds trees (all, or the names given) under
``build/variants/<name>/`` (git-ignored) whose ``csrc/merge.cu`` differs
from this tree's by a compile-time constant or a few lines, each timed once
after the turns:

  sort_256x64, sort_1024x16   tile_sort's threads x keys a thread
  merge_1buf                  merge_level with one window buffer (and one
                              producer warp) a CTA, not two
  merge_256                   merge_level with 256 merging threads
  merge_stride                merge_level's CTAs take tiles by a grid
                              stride, not a contiguous run each (a warp's
                              next search then spans 2 x grid tiles)
  merge_direct                merge_level stores each thread's 32 outputs
                              from registers (16-byte stores a lane, 128
                              bytes apart), not through shared memory
  select_step                 merge_path()'s serial step (both kernels)
                              as one load from a selected index and two
                              selects, not a branch with a load on each side
  bitonic_512x32              tile_sort as a bitonic network (the design
                              this kernel replaced) at 512 threads x 32
                              keys: the stages of distance < 32 run in
                              registers, the 45 others through shared
                              memory, a barrier each

``--every-level`` times every merge level of both sizes.  ``--ptxas``
prints ptxas's registers and shared memory for each tree's ``merge.cu``.
The last line is a JSON object with every run's times; the lines before it
a table of each measurement by tree.  Needs one card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import turns

MERGE_CU = "csrc/merge.cu"
HBM_BYTES_PER_MS = 3.35e9  # H100 SXM device memory, 3.35 TB/s

# merge_level's merged tile leaving through shared memory.
MERGE_STORE = """    merge_threads_sync();  // every read of the windows is done
#pragma unroll
    for (int j = 0; j < K; ++j) work[pad(d + j)] = v[j];
    merge_threads_sync();
    int4* out = reinterpret_cast<int4*>(y + t * kTile);
#pragma unroll
    for (int r = 0; r < kTile / 4 / kMergeThreads; ++r) {
      const int q = r * kMergeThreads + tid;
      out[q] = make_int4(work[pad(4 * q)], work[pad(4 * q + 1)],
                         work[pad(4 * q + 2)], work[pad(4 * q + 3)]);
    }"""

VARIANTS = {
    "sort_256x64": [("kSortThreads = 512;", "kSortThreads = 256;")],
    "sort_1024x16": [("kSortThreads = 512;", "kSortThreads = 1024;")],
    "merge_1buf": [("kMergeBuffers = 2;", "kMergeBuffers = 1;")],
    "merge_256": [("kMergeThreads = 512;", "kMergeThreads = 256;")],
    "merge_stride": [
        ("  const int64_t first = blockIdx.x * q + "
         "min((int64_t)blockIdx.x, rem);",
         "  const int64_t first = blockIdx.x;"),
        ("= first + k;", "= first + k * gridDim.x;")],
    "merge_direct": [(MERGE_STORE, """\
    int4* out = reinterpret_cast<int4*>(y + t * kTile + d);
#pragma unroll
    for (int j = 0; j < K / 4; ++j)
      out[j] = make_int4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
""")],
    "select_step": [("""    if (take_a)
      ka = s[pad(++ai)];
    else
      kb = s[pad(++bi)];""", """    ai += take_a;
    bi += !take_a;
    const int32_t next = s[pad(take_a ? ai : bi)];
    ka = take_a ? next : ka;
    kb = take_a ? kb : next;""")],
}
# tile_sort as a bitonic network: replaces the kernel from its
# __launch_bounds__ line to the line that closes it.
BITONIC_TILE_SORT = r"""
template <int D>
__device__ __forceinline__ void register_stage(int32_t (&v)[kSortItems],
                                               int first, int k) {
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    if ((j & D) == 0) {
      const bool asc = ((first + j) & k) == 0;
      const int32_t lo = min(v[j], v[j + D]);
      const int32_t hi = max(v[j], v[j + D]);
      v[j] = asc ? lo : hi;
      v[j + D] = asc ? hi : lo;
    }
  }
}

__global__ void __launch_bounds__(kSortThreads)
tile_sort_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ y) {
  extern __shared__ __align__(16) int32_t s[];
  constexpr int K = kSortItems;
  const int tid = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * kTile;
#pragma unroll
  for (int r = 0; r < K; ++r) s[pad(r * kSortThreads + tid)] =
      x[base + r * kSortThreads + tid];
  __syncthreads();
  const int first = tid * K;
  int32_t v[K];
#pragma unroll
  for (int j = 0; j < K; ++j) v[j] = s[pad(first + j)];
  for (int k = 2; k <= kTile; k <<= 1) {
    if (k > K) {
#pragma unroll
      for (int j = 0; j < K; ++j) s[pad(first + j)] = v[j];
      __syncthreads();
      for (int d = k >> 1; d >= K; d >>= 1) {
#pragma unroll
        for (int r = 0; r < kTile / 2 / kSortThreads; ++r) {
          const int p = r * kSortThreads + tid;
          const int i = ((p & ~(d - 1)) << 1) | (p & (d - 1));
          const bool asc = (i & k) == 0;
          const int32_t a = s[pad(i)];
          const int32_t b = s[pad(i + d)];
          s[pad(i)] = asc ? min(a, b) : max(a, b);
          s[pad(i + d)] = asc ? max(a, b) : min(a, b);
        }
        __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < K; ++j) v[j] = s[pad(first + j)];
    }
    if (k >= 32) register_stage<16>(v, first, k);
    if (k >= 16) register_stage<8>(v, first, k);
    if (k >= 8) register_stage<4>(v, first, k);
    if (k >= 4) register_stage<2>(v, first, k);
    register_stage<1>(v, first, k);
  }
#pragma unroll
  for (int j = 0; j < K; ++j) s[pad(first + j)] = v[j];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < K; ++r)
    y[base + r * kSortThreads + tid] = s[pad(r * kSortThreads + tid)];
}
"""


def bitonic(text: str) -> str:
    start = text.index("__global__ void __launch_bounds__(kSortThreads)")
    end = text.index("\n}\n", start) + 3
    return text[:start] + BITONIC_TILE_SORT.lstrip() + text[end:]


# ---------------------------------------------------------------- worker

def worker(every_level: bool) -> dict:
    sys.path.insert(0, os.getcwd())
    import torch

    import radix_sort_tpu_torch as rt
    from radix_sort_tpu_torch.ops import cuda_merge as cm

    dev = torch.device("cuda", 0)

    def check(ok, what):
        if not ok:
            raise SystemExit(f"validation failed: {what}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    res = {}
    for log2n in (25, 27):
        n = 1 << log2n
        keys = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32,
                             device=dev, generator=gen)
        x = keys ^ (-2**31)  # the kernels' sign-flipped domain
        tiles = cm.tile_sort(x)
        last = (n // cm.TILE).bit_length() - 2
        level_in, cur = {}, tiles
        for level in range(last + 1):
            level_in[level] = cur
            cur, _ = cm.merge_level(cur, level)
        check(bool((cur[1:] >= cur[:-1]).all()), f"2^{log2n}: not sorted")
        if log2n == 25:
            check(torch.equal(tiles, cm.tile_sort_plain(x)),
                  "tile_sort differs from plain")
            for level in (0, last):
                xin = level_in[level]
                got, splits = cm.merge_level(xin, level, with_splits=True)
                want = cm.level_splits_plain(xin, level)
                check(all(torch.equal(a, b) for a, b in zip(splits, want)),
                      f"level {level} splits differ from plain")
                check(torch.equal(got, cm.merge_level_plain(xin, *want)),
                      f"level {level} differs from plain")
            res["tile_sort 2^25"] = turns.device_ms(lambda: cm.tile_sort(x))
            res["torch.sort of the tiles 2^25"] = turns.device_ms(
                lambda: torch.sort(x.view(-1, cm.TILE), dim=-1, stable=True))
        res[f"copy (x.clone()) 2^{log2n}"] = turns.device_ms(lambda: x.clone())
        for level in (range(last + 1) if every_level else (0, last)):
            xin = level_in[level]
            res[f"merge_level {level} of 2^{log2n}"] = turns.device_ms(
                lambda: cm.merge_level(xin, level))
        del x, tiles, level_in, cur
        u = keys.view(torch.uint32)
        got = rt.sort(u, engine="merge")
        want = torch.sort(keys ^ (-2**31)).values ^ (-2**31)
        check(torch.equal(got.view(torch.int32), want), f"sort 2^{log2n}")
        res[f"sort merge u32 2^{log2n}"] = turns.time_ms(
            lambda: rt.sort(u, engine="merge"))
        res[f"torch.sort u32 2^{log2n}"] = turns.time_ms(
            lambda: rt.sort(u, engine="torch_sort"))
        if log2n == 25:
            cfg = rt.SortConfig(engine="merge")
            res["top_k merge 2^25 k=2^24"] = turns.time_ms(
                lambda: rt.top_k(u, 1 << 24, config=cfg))
        del keys, u, got, want
    # Range keys (the reference's iota from the type's minimum): every
    # output tile takes one whole window, and every merge step one side.
    n = 1 << 25
    x = torch.arange(n, dtype=torch.int64, device=dev).sub(2**31).to(
        torch.int32)
    level_in, cur = [], cm.tile_sort(x)
    for level in range(11):
        level_in.append(cur)
        cur, _ = cm.merge_level(cur, level)
    check(torch.equal(cur, x), "Range 2^25: levels differ from the keys")
    for level in (0, 10):
        res[f"merge_level {level} of 2^25 Range"] = turns.device_ms(
            lambda: cm.merge_level(level_in[level], level))
    u = (x ^ (-2**31)).view(torch.uint32)
    check(torch.equal(rt.sort(u, engine="merge").view(torch.int32),
                      u.view(torch.int32)), "sort Range 2^25")
    res["sort merge u32 Range 2^25"] = turns.time_ms(
        lambda: rt.sort(u, engine="merge"))
    return {"device": torch.cuda.get_device_name(0), "times": res}


# ------------------------------------------------------------------ trees

def ptxas(tree: Path) -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    res = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xptxas", "-v", "-c", str(tree / turns.PACKAGE / MERGE_CU),
         "-o", os.devnull], capture_output=True, text=True)
    lines = [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
             if "registers" in ln or "Compiling entry" in ln
             or "spill" in ln or "error" in ln]
    return "\n".join(lines)


def bound_ms(key: str) -> float | None:
    """The bytes the kernel must move over HBM's rate, for kernel rows."""
    n = 1 << int(re.search(r"2\^(\d+)", key).group(1))
    if key.startswith("tile_sort"):
        return 8 * n / HBM_BYTES_PER_MS
    if key.startswith("merge_level"):
        return (8 * n + 12 * (n // 16384)) / HBM_BYTES_PER_MS
    return None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--order", default="0,1,1,0,1,0")
    ap.add_argument("--variants", nargs="?", const="all", default="")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--every-level", action="store_true")
    ap.add_argument("--worker", action="store_true")
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.every_level)), flush=True)
        return 0
    parent = Path(args.parent).resolve() if args.parent else None
    trees = {"change": turns.ROOT}
    if parent:
        trees = {"parent": parent, **trees}
    wanted = set(args.variants.split(",")) - {""}
    if "all" in wanted:
        wanted = set(VARIANTS) | {"bitonic_512x32"}
    for name in wanted - set(VARIANTS) - {"bitonic_512x32"}:
        ap.error(f"no variant {name}")
    for name, subs in VARIANTS.items():
        if name in wanted:
            trees[name] = turns.make_tree(name, MERGE_CU, subs)
    if "bitonic_512x32" in wanted:
        trees["bitonic_512x32"] = turns.make_tree("bitonic_512x32",
                                                   MERGE_CU, [], bitonic)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    if args.ptxas:
        for name, tree in trees.items():
            print(f"[ptxas] {name}\n{ptxas(tree)}", flush=True)
    order = ([("parent", "change")[int(i)] for i in args.order.split(",")]
             if parent else ["change"])
    order += [name for name in trees if name not in ("parent", "change")]
    runs = turns.in_turns(__file__, trees, order,
                          *["--every-level"] * args.every_level)
    turns.print_table(runs, lambda key: "" if bound_ms(key) is None
                      else f" (bound {bound_ms(key):.4f} ms)")
    print(json.dumps({"trees": {k: str(v) for k, v in trees.items()},
                      "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
