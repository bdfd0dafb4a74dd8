"""Where a onesweep pass spends its time: device time of the pass kernel by
mode, plane count, radix and tile shape, on one card.

    python3 scripts/onesweep_probe.py [--log2n 27]

Times with torch.profiler's kernel rows (the kernel alone, no memset and
no host work), 20 calls each, on u32 RandomDistributed keys + an int32
iota payload, at the sort's default tile unless a row names another:

  - look-back mode (``onesweep_pass``) and base-table mode
    (``rank_scatter`` with a ``_stitch_block_base`` table) with 0, 1 (the
    digit plane), 2 and 3 planes: the plane-free rows are the rank (and
    look-back) alone, the differences the scatter of a plane;
  - radix 16 and 256; every compiled (tile, threads) shape; sorted
    (Range) and constant (Zeros) keys at the default tile;
  - ``pass_histograms`` over 4 passes, and the 64-bit look-back words
    (n = 2^30 + 4099, KV);
  - the bound of each row: the bytes it must move at 3.35 TB/s.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from radix_sort_tpu_torch import datasets, dtypes  # noqa: E402
from radix_sort_tpu_torch.config import (  # noqa: E402
    DEFAULT_CONFIG, KERNEL_SHAPES)
from radix_sort_tpu_torch.ops import cuda_radix as cr  # noqa: E402

CALLS = 20


def kernel_ms(fn, name: str) -> float:
    """Mean device time of the kernels named ``name`` a call of ``fn``."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and name in e.name]
    if not rows:
        raise SystemExit(f"no {name} kernel in the profile")
    return sum(e.device_time_total for e in rows) / CALLS / 1e3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--log2n", type=int, default=27)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    n = 1 << args.log2n
    tile = DEFAULT_CONFIG.tile_elems
    keys = dtypes.tensor_from_numpy(
        datasets.RandomDistributed(np.uint32, seed=0).generate(n),
        dev).view(torch.int32)
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    plane_sets = {0: (), 1: (keys,), 2: (keys, iota), 3: (keys, iota, iota)}

    def row(what, ms, nbytes):
        bound = nbytes / 3.35e9
        print(f"{what:58s} {ms:9.4f} ms  bound {bound:8.4f}  share "
              f"{bound / ms:6.3f}", flush=True)

    for radix, shift in ((256, 8), (16, 4)):
        counts = torch.bincount(cr._digits(keys, radix, shift).long(),
                                minlength=radix).int()
        hist = cr.digit_histogram(keys, radix, tile, shift)
        base = cr._stitch_block_base(hist)
        for k, planes in plane_sets.items():
            nbytes = 4 * n * (1 + 2 * k - (1 if k else 0))
            ms = kernel_ms(lambda: cr.onesweep_pass(
                keys, planes, counts, radix, tile, shift), "rank_scatter")
            row(f"look-back R={radix} {k} planes", ms, nbytes)
            ms = kernel_ms(lambda: cr.rank_scatter(
                keys, planes, base, radix, tile, shift), "rank_scatter")
            row(f"base-table R={radix} {k} planes", ms,
                nbytes + 4 * base.numel())
    counts = torch.bincount(cr._digits(keys, 256, 8).long(),
                            minlength=256).int()
    for shape_tile, threads in KERNEL_SHAPES:
        ms = kernel_ms(lambda: cr.onesweep_pass(
            keys, (keys, iota), counts, 256, shape_tile, 8, threads=threads),
            "rank_scatter")
        row(f"look-back R=256 KV tile {shape_tile} x {threads} threads", ms,
            16 * n)
    for what, k in (("Range", torch.arange(n, dtype=torch.int32, device=dev)),
                    ("Zeros", torch.zeros(n, dtype=torch.int32, device=dev))):
        c = torch.bincount(cr._digits(k, 256, 8).long(), minlength=256).int()
        ms = kernel_ms(lambda: cr.onesweep_pass(k, (k, iota), c, 256, tile,
                                                8), "rank_scatter")
        row(f"look-back R=256 KV {what} keys, shift 8", ms, 16 * n)
    ms = kernel_ms(lambda: cr.pass_histograms((keys,), (4,), 256),
                   "pass_histograms")
    row("pass_histograms u32, 4 passes", ms, 4 * n + 4096)
    del keys, iota, plane_sets
    m = (1 << 30) + 4099
    big = torch.randint(-2**31, 2**31 - 1, (m,), dtype=torch.int32,
                        device=dev)
    pay = torch.arange(m, dtype=torch.int32, device=dev)
    counts = torch.bincount(cr._digits(big, 256, 8).long(),
                            minlength=256).int()
    ms = kernel_ms(lambda: cr.onesweep_pass(big, (big, pay), counts, 256,
                                            tile, 8), "rank_scatter")
    row("look-back R=256 KV n=2^30+4099 (64-bit status words)", ms, 16 * m)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
