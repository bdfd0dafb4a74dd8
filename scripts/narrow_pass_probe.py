"""The radix pass at 8- and 16-bit key widths on one card, beside 32 bits.

    python3 scripts/narrow_pass_probe.py [--log2n 27] [--ptxas]

On RandomDistributed keys made on the card (uint8, float16; uint32 for the
32-bit rows) and an int32 iota payload at n = 2^log2n, each checked bit
for bit against its plain version first:

  - ``pass_histograms``: u32 (4 passes), u8 (1) and f16 (2), one launch
    each, with its bound (the key plane read once, the table written);
  - ``onesweep_pass`` in look-back mode: a u32 KV pass, the u8 KV pass and
    both f16 KV passes, and a key-only u8 pass, with their bounds (each
    moved plane read and written once, the digit plane read once more
    where it is not moved);
  - ``sort_kv``, ``sort`` and ``argsort`` of uint8, int8 and float16 keys
    beside a bare ``torch.sort(keys, stable=True)`` (and argsort's iota
    alone, beside ``torch.arange``'s), and torch.profiler's device time of a
    float16 ``sort_kv`` and ``argsort`` by kernel.

Kernel rows are device time (``chip_smoke.device_ms``: CUDA events around
50 back-to-back calls, divided by 50, median of 3); sorts are one call's
event time with its host work (``chip_smoke.time_ms``, median of 5).
``--ptxas`` first prints ptxas's registers, spills and shared memory for
every instance of the pass kernels in ``csrc/radix.cu``.  Needs one card.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import turns

sys.path.insert(0, str(turns.ROOT))
import radix_sort_tpu_torch as rt  # noqa: E402
from radix_sort_tpu_torch.ops import cuda_radix as cr  # noqa: E402
from radix_sort_tpu_torch.ops import sort as sort_ops  # noqa: E402

device_ms = turns.device_ms
time_ms = turns.time_ms
HBM_BYTES_PER_MS = 3.35e9  # H100 SXM device memory, 3.35 TB/s
RADIX_CU = turns.ROOT / turns.PACKAGE / "csrc" / "radix.cu"


def ptxas() -> None:
    """ptxas's line for each instance of pass_histograms_kernel and
    rank_scatter_kernel, its name demangled."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    res = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xptxas", "-v", "-c", str(RADIX_CU), "-o", "/dev/null"],
        capture_output=True, text=True, check=True)
    filt = shutil.which("cu++filt") or str(Path(nvcc).parent / "cu++filt")
    name = None
    for line in res.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = subprocess.run([filt, m.group(1)], capture_output=True,
                                  text=True).stdout.strip()
            continue
        if name and ("registers" in line or "spill" in line):
            if "pass_histograms" in name or "rank_scatter" in name:
                print(f"[ptxas] {name}: {line.split(':', 1)[-1].strip()}",
                      flush=True)


def bound(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_MS


def row(what: str, ms: float, nbytes: int) -> None:
    b = bound(nbytes)
    print(f"[probe] {what}: device {ms:.5f} ms, bound {b:.5f} ms, share "
          f"{b / ms:.3f}", flush=True)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return bool((a == b).all())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--log2n", type=int, default=27)
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    if args.ptxas:
        ptxas()
    dev = torch.device("cuda", 0)
    n = 1 << args.log2n
    gen = rt.datasets_device.generate
    u8 = gen("RandomDistributed", np.uint8, n, seed=4, device=dev)
    f16 = gen("RandomDistributed", np.float16, n, seed=5, device=dev)
    u32 = gen("RandomDistributed", np.uint32, n, seed=6,
              device=dev).view(torch.int32)
    iota = torch.arange(n, dtype=torch.int32, device=dev)

    hist_cases = (("u32 (4 passes)", u32, 4, "u", 4),
                  ("u8 (1 pass)", u8, 1, "u", 1),
                  ("f16 (2 passes)", f16, 2, "f", 2))
    for what, k, passes, kind, width in hist_cases:
        got = cr.pass_histograms((k,), (passes,), 256, kind=kind)
        want = cr.pass_histograms_plain((k,), (passes,), 256, kind)
        if not bool((got == want).all()):
            raise SystemExit(f"pass_histograms {what} disagrees")
        ms = device_ms(lambda: cr.pass_histograms((k,), (passes,), 256,
                                                  kind=kind))
        row(f"pass_histograms {what} 2^{args.log2n}", ms,
            width * n + 4 * 256 * passes)

    pass_cases = (("u32 KV, shift 8", u32, (u32, iota), 8, "u", 16),
                  ("u8 KV", u8, (u8, iota), 0, "u", 10),
                  ("u8 key-only", u8, (u8,), 0, "u", 2),
                  ("f16 KV, shift 0", f16, (f16, iota), 0, "f", 12),
                  ("f16 KV, shift 8", f16, (f16, iota), 8, "f", 12))
    for what, k, planes, shift, kind, per in pass_cases:
        counts = torch.bincount(cr._digits(k, 256, shift, kind).long(),
                                minlength=256).int()
        outs, _ = cr.onesweep_pass(k, planes, counts, 256, 8192, shift,
                                   kind=kind)
        want, _ = cr.onesweep_pass_plain(k, planes, 256, 8192, shift,
                                         kind=kind)
        if not all(same_bits(a, b) for a, b in zip(outs, want)):
            raise SystemExit(f"onesweep_pass {what} disagrees")
        del outs, want
        ms = device_ms(lambda: cr.onesweep_pass(k, planes, counts, 256,
                                                8192, shift, kind=kind))
        row(f"onesweep_pass {what} 2^{args.log2n}", ms, per * n + 4 * 256)

    for dtype in (np.uint8, np.int8, np.float16):
        keys = gen("RandomDistributed", dtype, n, seed=9, device=dev)
        name = np.dtype(dtype).name
        ko, perm = rt.sort_kv(keys, iota)
        img = rt.dtypes.to_sortable(keys)  # the check's own image
        if not bool((img[perm.long()] == rt.dtypes.to_sortable(ko)).all()):
            raise SystemExit(f"sort_kv {name}: keys_in[payload] != keys_out")
        if not bool((rt.argsort(keys) == perm).all()) or not same_bits(
                rt.sort(keys), ko):
            raise SystemExit(f"sort / argsort {name} disagree with sort_kv")
        times = {"sort_kv": time_ms(lambda: rt.sort_kv(keys, iota)),
                 "sort": time_ms(lambda: rt.sort(keys)),
                 "argsort": time_ms(lambda: rt.argsort(keys)),
                 "bare torch.sort": time_ms(
                     lambda: torch.sort(keys, stable=True)),
                 "torch.arange's iota alone": time_ms(lambda: torch.arange(
                     n, dtype=torch.int32, device=dev)),
                 "argsort's iota alone": time_ms(
                     lambda: sort_ops._iota(n, dev))}
        print(f"[probe] {name} 2^{args.log2n}: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in times.items()), flush=True)
        del keys, ko, perm, img

    keys = gen("RandomDistributed", np.float16, n, seed=9, device=dev)
    for what, fn in (("sort_kv", lambda: rt.sort_kv(keys, iota)),
                     ("argsort", lambda: rt.argsort(keys))):
        profile(f"float16 {what} 2^{args.log2n}", fn)
    return 0


def profile(what: str, fn, iters: int = 3) -> None:
    """torch.profiler's device time a call of fn, by kernel."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.name] = (by_kernel.get(e.name, 0.0)
                                 + e.device_time_total / iters / 1e3)
    total = sum(by_kernel.values())
    print(f"[probe] {what} device {total:.4f} ms a call: " + "; ".join(
        f"{k[:60]} {v:.4f}" for k, v in sorted(
            by_kernel.items(), key=lambda kv: -kv[1])), flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
