"""Drive the PyTorch/CUDA port's main path once on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels of ``radix_sort_tpu_torch`` from ``csrc/`` (into
``build/kernels/``, one ``nvcc`` a source, started together) and the native
host baselines of ``native/`` where a C++ compiler is present, holds each
kernel bit-exact against its plain torch version at the shapes the main
path gives it (the onesweep pass in look-back mode at u32 KV 2^27 on
RandomDistributed and Zeros, u64 KV 2^27, u8 and f16 KV 2^27 on the
caller's narrow key planes with their base-table launch beyond 16 planes
and a view off a 4-byte boundary, a ragged n, 17 planes, the
partition's pass, and the pass kernel's wide instance with 8-byte planes
(a u32 key and an int64 payload at 2^27, and Q1's mixed set of one key,
seven 8-byte and four 4-byte planes at a ragged n); the sort's plan at u32 KV 2^27, launch by launch against
the plain plan: a filled pass, a filled pass before a running one, and a
sort that runs no pass, whose last launch copies its input into new
storage; ``[enqueue]``: ``sort_passes``, a whole sort or partition in
one call into the kernel library (``rst_sort_planes``), against the
per-pass launches and the plain version at u32 key-only 2^20, u32 KV 2^27
(RandomDistributed, Zeros), u64 KV 2^24, u8 and f16 KV 2^27, a 17-plane
KV and partitions at 256 and 1000 buckets, then config 1's sort beside
``torch.sort`` and config 4 beside ``engine="torch_sort"`` (one call's
ms, the host's enqueue µs, device ms); ``pass_histograms`` at 2^27 for
8-, 16-, 32- and 64-bit keys, the 8- and 16-bit ones on the caller's keys;
``rank_scatter`` in base-table mode at 2^22; ``tile_sort`` and every
``merge_level`` of a 2^25 merge sort on RandomDistributed, Zeros, Range and
disjoint runs, levels 0 and 10 against the plain versions with their
splits and against ``torch.sort`` of each pair of runs, and
``merge_level``'s device time and bound share at level 0 and
the last level of 2^25 and 2^27), then runs five paths at
BASELINE sizes through the public entry points, each with the kernels'
launch counters set to 0 just before it and read just after:

  the radix path
  - ``sort_kv``: u32 keys + int32 iota payload at 2^27 over the five
    ``datasets`` distributions, u64 keys at 2^27, and ``sort`` u32 key-only
    at 2^25, each timed beside ``engine="torch_sort"`` (torch.sort);
  - ``[profile]``: a u32 KV 2^27 sort's launches (1 ``pass_histograms``,
    4 ``onesweep_pass``), host reads (0) and device time by kernel, and the
    idle share of back-to-back u32 key-only sorts at 2^25;
  - ``[nosync]``: ``sort``, ``sort_kv`` and ``argsort`` of u32, u64, u8
    and f16 keys at 2^20 and 2^27 on RandomDistributed and Zeros, a
    1000-bucket ``stable_partition(method="stream")``,
    ``compact_mask(method="stream")``, config 3's filter -> aggregate and
    config 4's join, each under ``torch.cuda.set_sync_debug_mode("error")``:
    a host sync fails the run;
  - config 3: ``filter_expr(k < 500)`` → ``hash_aggregate(count, sum)`` over
    2^26 rows, checked against ``np.bincount``;
  - config 4: ``hash_join`` of a 2^20-row probe against a 2^18-row unique
    build, checked against numpy (configs 3, 4 and 5 as
    scripts/torch_baseline_configs.py runs and checks them);
  - ``[dtypes]``: ``sort_kv`` of uint8, int8 and float16 keys + int32 iota
    at 2^27 (RandomDistributed made on the card, and uint8 Zeros) on the
    narrow pass, each in one ``pass_histograms`` and one ``onesweep_pass``
    a byte of key, all with the caller's 8- or 16-bit key plane (a pass
    that one digit fills is launched and returns at once), with no
    ``to_sortable`` /
    ``from_sortable`` on the way, checked like ``[sort]`` with every key
    against a counting sort of the sortable images, ``sort`` and
    ``argsort`` equal to its keys and payload, all three timed beside
    ``engine="torch_sort"`` and a bare ``torch.sort(keys, stable=True)``
    on the caller's narrow tensor; then a ``Query`` over 2^26 rows
    (``group_by`` a uint8 key with count/sum/min/max of a float16 column,
    ``top_k`` of that column, a window ordered by an int8 key) against
    numpy oracles;

  the merge path
  - ``sort(engine="merge")``: u32 key-only at 2^25 over the five
    distributions, i32 and f32 at 2^25, u32 at 2^25 - 777 and at 2^27, each
    timed beside ``radix`` and ``torch_sort``;
  - ``[profile]``: a merge sort at 2^25 and at 2^27 launches one
    ``tile_sort`` and one ``merge_level`` a level and nothing else (the
    counters and the profiler's rows: no split kernel), its device time by
    kernel (``tile_sort``, ``merge_level``, the torch glue of
    ``merge_sort_bits``) and the idle share over back-to-back sorts;
  - ``top_k`` at 2^25 with k = 2^24 under ``engine="merge"`` and k = 1024,
    and ``top_k_kv`` with heavy ties, against numpy;
  - the harness: ``run_all`` over u32/i32/u64/i64 x five distributions at
    2^22, and a key-only ``SortTask`` under ``engine="merge"`` at 2^25,
    every row valid; the CSV rows are printed;

  the query path (every sort and compaction on the radix kernels; each
  query also timed with its sorts on ``engine="torch_sort"``)
  - ``[query]``: the SELECT of examples/query_pipeline.py (filter → join →
    group_by → sort_by, then the top 3 regions) over 2^26 orders and 2^22
    customers, checked against ``np.bincount``;
  - ``[window]``: ``Query.window`` with every kind over 2^22 and 2^26 rows
    (2^16 partitions, 4099 padding rows), every row of 2^22 against a
    numpy oracle from ``np.lexsort``, 2^26 by checks on the card; the
    segmented scans' share of the window's device time;
  - ``[sort_by]``: three keys (u32, int16 descending, f32) over 2^26 rows
    against ``np.lexsort``, with int64 and float64 columns riding as
    8-byte planes (the query path must launch the wide instance);
  - ``[segment]``: ``hash_aggregate(method="segment")`` against
    ``method="scan"`` on config 3's 2^26 rows;
  - ``[io]``: ``save_table`` / ``load_table`` of 2^24 rows bit for bit and
    a ``BatchWriter`` of 4 batches;
  - ``[datasets_device]``: each distribution as u32, i64 and f32 at 2^25
    made on the card, its contract checked and its sort validated, beside
    the host generator plus the upload;
  - ``[examples]``: the three port examples as subprocesses on the card;

  the dist path (radix_sort_tpu_torch.parallel, in rank processes started
  by ``mesh.run_ranks``; their launch counts are added to this process's,
  and every rank must launch ``pass_histograms`` and ``onesweep_pass``)
  - ``[dist1]``: one NCCL rank on the card: ``dist_sort_kv`` of u32 keys +
    int32 iota at 2^27 on RandomDistributed and Zeros, bit for bit
    ``sort_kv``'s and timed beside it; BASELINE config 5 (zipf(1.3) % 4096
    probe keys, a unique 4096-key build) at 2^26 probe rows, as
    scripts/torch_baseline_configs.py runs it: ``dist_hash_join``,
    ``dist_hash_aggregate(count)`` and ``dist_sort_kv``, checked against
    numpy; ``health_check``;
  - ``[dist4]``: four gloo ranks sharing the card (every rank's tensors on
    cuda:0; a gloo exchange goes through host memory) at 2^22 rows a
    rank: ``dist_sort_kv`` over the five distributions, full-range u64 and
    the Zipf keys at G = 1 and 2 against ``np.argsort(kind="stable")``,
    config 5 at 2^24 rows, ``dist_top_k`` with ties;
  - ``[chunked]``: ``sort_kv(engine="chunked")`` of u32 and u64 KV at 2^27
    on RandomDistributed and Zeros, bit for bit ``radix`` and
    ``torch_sort`` on the same data, timed beside both;

  the bench path (the port's measurement entry points, through their
  functions; every one of the seven kernels must launch on it)
  - ``[headline]``: bench_torch.py at 2^25 under ``auto`` (radix) and
    ``merge``, each JSON line printed;
  - scripts/torch_benchmark.py over 2^25, 2^20, 2^15 and 2^10, u32 and u64,
    the five distributions, with the phase columns (``digit_histogram``,
    ``exclusive_scan``, ``rank_scatter``) and the CPU baselines below 2^25,
    every row valid, the CSVs written to chiprun_out/;
  - scripts/torch_baseline_configs.py configs 1 and 2 (u32 and u64 KV at
    2^27), written to chiprun_out/baseline_results_torch.json;
  - ``[scaling]``: scripts/torch_scaling_bench.py with ``--check-ops`` at
    2^22 rows a rank, one NCCL rank, then two and four gloo ranks sharing
    the card.

Every phase raises on a failure, so the exit code is non-zero and the last
line is not printed.  The last line is the JSON object
``{"ok": true, "device": {...}}``; the line before it lists each kernel (and
``pass_histograms`` and ``onesweep_pass`` again with 8- and 16-bit key
planes, timed on u8 and f16 KV at 2^27, their launches counted apart, and
``onesweep_pass_wide``: the pass with an 8-byte plane, timed on a u32 key
and an int64 payload at 2^27, its launches those of the wide instance in
either mode) with
its launch count summed over the five paths, its device time beside the plain
version's (``ms``, ``plain_ms``: CUDA events around 50 back-to-back calls,
divided by 50), its bound (``bound_ms``: the bytes it must move at 3.35
TB/s), the time of one PyTorch call that computes the same function where
there is one (``library_ms``), and the time of one call with its host work
(``call_ms``, ``plain_call_ms``: CUDA events around a single call).
Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

RADIX_CU = "radix_sort_tpu_torch/csrc/radix.cu"
PASS_CUH = "radix_sort_tpu_torch/csrc/radix_pass.cuh"  # rank_scatter's kernel
MERGE_CU = "radix_sort_tpu_torch/csrc/merge.cu"
K3_K4 = ("radix_sort_tpu/ops/pallas_radix.py:263; "
         "radix_sort_tpu/ops/pallas_stream.py:427")
REPLACES = {
    "digit_histogram": "radix_sort_tpu/ops/pallas_radix.py:140",
    "exclusive_scan": "radix_sort_tpu/ops/pallas_radix.py:217",
    "rank_scatter": K3_K4,  # base-table mode
    "pass_histograms": "radix_sort_tpu/ops/pallas_radix.py:140",
    "onesweep_pass": K3_K4,  # look-back mode of the same kernel
    # the same two kernels with the caller's 8- or 16-bit key plane (rows
    # timed on u8 and f16 KV; launches counted apart, and in the totals)
    "pass_histograms_8bit": "radix_sort_tpu/ops/pallas_radix.py:140",
    "pass_histograms_16bit": "radix_sort_tpu/ops/pallas_radix.py:140",
    "onesweep_pass_8bit": K3_K4,
    "onesweep_pass_16bit": K3_K4,
    # the same kernel's wide instance: some plane of 8 bytes (launches of
    # it in look-back and base-table mode; in the totals of both too)
    "onesweep_pass_wide": K3_K4,
    "tile_sort": "radix_sort_tpu/ops/pallas_merge.py:265",
    "merge_level": "radix_sort_tpu/ops/pallas_merge.py:283",
}
SOURCES = {k: MERGE_CU if k in ("tile_sort", "merge_level") else
           PASS_CUH if REPLACES[k] == K3_K4 else RADIX_CU for k in REPLACES}
NARROW_KERNELS = ("pass_histograms_8bit", "pass_histograms_16bit",
                  "onesweep_pass_8bit", "onesweep_pass_16bit")
WIDE_KERNELS = ("onesweep_pass_wide",)
REPS = 5
HBM_BYTES_PER_MS = 3.35e9  # H100 SXM device memory, 3.35 TB/s


def bound_ms(nbytes: int) -> float:
    """Least time to move ``nbytes`` (each input read once, each output
    written once) at the card's memory rate."""
    return nbytes / HBM_BYTES_PER_MS


class SmokeFailure(RuntimeError):
    pass


def require(ok, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def time_ms(fn, reps: int = REPS) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm-up.
    The window holds the host work of the call (allocation, launch) as
    well as the device's."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, calls: int = 50, reps: int = 3) -> float:
    """Device time of one call of ``fn``: CUDA events around ``calls``
    back-to-back calls, divided by ``calls``; median of ``reps``.  The
    calls queue behind a ~10 ms ``torch.cuda._sleep``, so the host has
    enqueued them before the first starts and its work stays out of the
    window."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(20_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def enqueue_us(fn, calls: int = 20) -> float:
    """The host's time to enqueue one call of ``fn``, in microseconds:
    ``time.perf_counter`` around the call with no sync (the card idle
    before each), median of ``calls`` after a warm-up."""
    fn()
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(times)) * 1e6


def timings(fn, plain) -> dict:
    """A kernel's and its plain version's device and single-call times."""
    return {"ms": device_ms(fn), "plain_ms": device_ms(plain),
            "call_ms": time_ms(fn), "plain_call_ms": time_ms(plain)}


def bits_of(x: torch.Tensor) -> torch.Tensor:
    """A float16 tensor's bits as int16 (NaNs compare by their bits);
    other tensors as they are."""
    return x.view(torch.int16) if x.dtype == torch.float16 else x


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    require(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def xor_reduce(x: torch.Tensor) -> int:
    """XOR of every element, by halving (torch has no xor reduction)."""
    x = x.clone()
    while x.numel() > 1:
        if x.numel() % 2:
            x = torch.cat([x, x.new_zeros(1)])
        x = x[0::2] ^ x[1::2]
    return int(x[0])


def phase_device():
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this smoke "
                           "test needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    return card


# launches counted in rank processes of the dist path, added to this
# process's counters by launch_counts()
CHILD_LAUNCHES: dict = {}


def launch_counts():
    from radix_sort_tpu_torch.ops import cuda_merge, cuda_radix

    own = {**cuda_radix.launch_counts(), **cuda_radix.narrow_launch_counts(),
           **cuda_merge.launch_counts()}
    own["onesweep_pass_wide"] = own.pop("wide_launches")
    return {k: v + CHILD_LAUNCHES.get(k, 0) for k, v in own.items()}


def reset_launch_counts():
    from radix_sort_tpu_torch.ops import cuda_merge, cuda_radix

    cuda_radix.reset_launch_counts()
    cuda_merge.reset_launch_counts()
    CHILD_LAUNCHES.clear()


def script(name: str):
    """A module of the port's entry points (``bench_torch`` at the root,
    ``torch_*`` in ``scripts/``), imported by name with both directories
    on the path, so the rank processes that run_ranks spawns (which start
    from this process's path) import it too."""
    import importlib

    here = os.path.dirname(os.path.abspath(__file__))
    for d in (here, os.path.join(here, "scripts")):
        if d not in sys.path:
            sys.path.insert(0, d)
    return importlib.import_module(name)


def phase_build():
    from radix_sort_tpu_torch import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    print(f"[build] {path.name} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    # The harness times the reference's C++ host baselines where they are
    # built, and golden.cpu_radix_sort (much slower at 2^25) where not.
    t0 = time.perf_counter()
    try:
        res = subprocess.run(["make", "-C", "native"], capture_output=True,
                             text=True, timeout=300)
        built = res.returncode == 0
        why = res.stderr.strip()[-300:]
    except (OSError, subprocess.TimeoutExpired) as e:
        built, why = False, str(e)
    print(f"[build] native/libhostbaseline.so "
          f"{'built' if built else 'not built: ' + why} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


def phase_kernels(dev, rt, cr, cm):
    """Each kernel against its plain version on the same card tensors,
    timed at the main path's shapes beside its bound and, where one
    PyTorch call computes the same function, that call."""
    rng = np.random.default_rng(0)
    res = {k: {"max_abs_err": 0, "library_ms": None} for k in REPLACES}
    before = launch_counts()

    def note(name, err, times=None, nbytes=None, library=None):
        r = res[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r.update(times or {})
        if nbytes is not None:
            r["bound_ms"], r["bound_by"] = bound_ms(nbytes), "bytes"
        if library is not None:
            r["library_ms"] = device_ms(library)

    n = 1 << 27
    x = torch.from_numpy(rng.integers(-2**31, 2**31, n, dtype=np.int64)
                         .astype(np.int32)).to(dev)
    for radix, shift, size in ((2, 0, 1 << 26), (16, 4, 1 << 26),
                               (256, 8, 1 << 27)):
        xs = x[:size]
        got = cr.digit_histogram(xs, radix, 4096, shift)
        want = cr.digit_histogram_plain(xs, radix, 4096, shift)
        err = max_abs_err(got, want)
        require(err == 0, f"digit_histogram R={radix} disagrees")
        print(f"[kernels] digit_histogram n={size} R={radix}: bit-exact",
              flush=True)
    note("digit_histogram", 0,
         timings(lambda: cr.digit_histogram(x, 256, 4096, 8),
                 lambda: cr.digit_histogram_plain(x, 256, 4096, 8)),
         nbytes=4 * n + 4 * 256 * (n // 4096))

    # pass_histograms: every pass of a u32 and of a u64 key at 2^27, one
    # launch each (R = 256), R = 2 / 16 over one plane, and the caller's
    # u8 and f16 keys as narrow key planes (R = 256 and 16)
    hi = torch.from_numpy(rng.integers(0, 1 << 20, n).astype(np.int32)).to(dev)
    k8, k16 = narrow_keys(rt, n, dev)
    cases = [("u8 keys 2^27 (1 pass)", (k8,), (1,), 256, "u"),
             ("f16 keys 2^27 (2 passes)", (k16,), (2,), 256, "f"),
             ("f16 keys 2^27 R=16 (4 passes)", (k16,), (4,), 16, "f"),
             ("u32 2^27 (4 passes)", (x,), (4,), 256, "u"),
             ("u64 2^27 (lo + hi, 8 passes)", (x, hi), (4, 4), 256, "u"),
             ("u32 2^27 R=16 (8 passes)", (x,), (8,), 16, "u"),
             ("u32 2^26 R=2 (32 passes)", (x[:1 << 26],), (32,), 2, "u")]
    for what, planes, passes, radix, kind in cases:
        err = max_abs_err(cr.pass_histograms(planes, passes, radix, kind),
                          cr.pass_histograms_plain(planes, passes, radix,
                                                   kind))
        require(err == 0, f"pass_histograms {what} disagrees")
        print(f"[kernels] pass_histograms {what}: bit-exact", flush=True)
    t = timings(lambda: cr.pass_histograms((x,), (4,), 256),
                lambda: cr.pass_histograms_plain((x,), (4,), 256))
    note("pass_histograms", 0, t, nbytes=4 * n + 4 * 4 * 256)
    t64 = device_ms(lambda: cr.pass_histograms((x, hi), (4, 4), 256))
    print(f"[kernels] pass_histograms u32 2^27: device {t['ms']:.5f} ms "
          f"(bound {res['pass_histograms']['bound_ms']:.5f} ms), plain "
          f"{t['plain_ms']:.5f} ms; u64 2^27: {t64:.5f} ms", flush=True)
    for name, k, passes, kind, library in (
            ("pass_histograms_8bit", k8, 1, "u",
             lambda: torch.bincount(k8, minlength=256)),
            ("pass_histograms_16bit", k16, 2, "f", None)):
        note(name, 0, timings(
            lambda: cr.pass_histograms((k,), (passes,), 256, kind),
            lambda: cr.pass_histograms_plain((k,), (passes,), 256, kind)),
             nbytes=k.element_size() * n + 4 * passes * 256, library=library)
        r = res[name]
        print(f"[kernels] {name} ({k.dtype} keys 2^27, {passes} passes): "
              f"device {r['ms']:.5f} ms, bound {r['bound_ms']:.5f} ms, share "
              f"{r['bound_ms'] / r['ms']:.3f}; plain {r['plain_ms']:.5f} ms",
              flush=True)
    del x, hi, k8, k16

    # K2 on the (R*B) histograms of a 2^27 and a 2^25 sort (2^23 and 2^21
    # counts), a ragged size, values that wrap int32, and a view that
    # starts 12 bytes past a 16-byte boundary.
    rb = 256 * ((1 << 27) // 4096)
    wrap = torch.from_numpy(rng.integers(-2**31, 2**31, 1000003 + 3)
                            .astype(np.int32)).to(dev)
    cases = [(f"n={m}", torch.from_numpy(rng.integers(0, 4096, m)
                                         .astype(np.int32)).to(dev))
             for m in (rb, rb // 4, 1000003)]
    cases += [("n=1000003 wrapping int32", wrap[:-3]),
              ("n=1000003 view x[3:]", wrap[3:])]
    for what, y in cases:
        err = max_abs_err(cr.exclusive_scan(y), cr.exclusive_scan_plain(y))
        require(err == 0, f"exclusive_scan {what} disagrees")
        print(f"[kernels] exclusive_scan {what}: bit-exact", flush=True)
    for what, y in (cases[1], cases[0]):  # the JSON line keeps 2^23's
        t = timings(lambda: cr.exclusive_scan(y),
                    lambda: cr.exclusive_scan_plain(y))
        print(f"[kernels] exclusive_scan {what}: device {t['ms']:.5f} ms "
              f"({8 * y.numel() / t['ms'] / 1e9:.3f} TB/s of 8 B an "
              f"element), plain {t['plain_ms']:.5f} ms; one call "
              f"{t['call_ms']:.5f} ms, plain {t['plain_call_ms']:.5f} ms",
              flush=True)
    note("exclusive_scan", 0, t, nbytes=8 * y.numel(),
         library=lambda: torch.cumsum(y, 0, dtype=torch.int32))
    del cases, wrap

    # rank_scatter in base-table mode, as PRs 1-3 held it, at 2^22
    n = 1 << 22
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    for ds in (rt.datasets.RandomDistributed(np.uint32, seed=0),
               rt.datasets.Zeros(np.uint32)):
        keys = rt.dtypes.tensor_from_numpy(ds.generate(n), dev).view(
            torch.int32)
        planes = (keys, iota, iota * 3)
        base = cr._stitch_block_base(cr.digit_histogram(keys, 256, 4096, 0))
        outs, dest = cr.rank_scatter(keys, planes, base, 256, 4096, 0,
                                     with_dest=True)
        pouts, pdest = cr.rank_scatter_plain(keys, planes, base, 256, 4096, 0,
                                             with_dest=True)
        err = max(max_abs_err(a, b) for a, b in
                  zip(outs + (dest,), pouts + (pdest,)))
        require(err == 0, f"rank_scatter on {ds.name} disagrees")
        print(f"[kernels] rank_scatter n={n} {ds.name} (dest + 3 planes): "
              f"bit-exact", flush=True)
        if ds.name == "RandomDistributed":
            note("rank_scatter", 0,
                 timings(lambda: cr.rank_scatter(keys, planes, base, 256,
                                                 4096, 0, with_dest=True),
                         lambda: cr.rank_scatter_plain(
                             keys, planes, base, 256, 4096, 0,
                             with_dest=True)),
                 nbytes=4 * 7 * n + 4 * base.numel())
    del keys, planes, base, outs, dest, pouts, pdest, iota

    phase_onesweep(dev, rt, cr, note, res)
    phase_enqueue(dev, rt, cr)

    phase_merge_kernels(dev, rt, cm, note, res)
    after = launch_counts()
    for name in REPLACES:
        require(after[name] > before[name], f"{name} launch counter idle")
    torch.cuda.synchronize()
    return res


def disjoint_runs(n: int, tile: int, dev) -> torch.Tensor:
    """Keys in the merge kernels' domain whose tile i holds values of
    [i, i + 1) * 2^32 / tiles - 2^31, shuffled: tile_sort has real work, and
    at every merge level all of run A lies below run B, so each output tile
    takes one whole window (la is 0 or TILE)."""
    tiles = n // tile
    width = (1 << 32) // tiles
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    low = torch.randint(0, width, (n,), dtype=torch.int64, device=dev,
                        generator=gen)
    tile_id = torch.arange(n, dtype=torch.int64, device=dev) // tile
    return (tile_id * width + low - 2**31).to(torch.int32)


def phase_merge_kernels(dev, rt, cm, note, res):
    """K5 and K6 at the shapes of a key-only merge sort, on keys in the
    kernels' sign-flipped domain: every level of 2^25 (2048 tiles) on
    RandomDistributed, Zeros, Range and disjoint runs, levels 0 and the last
    checked against the plain versions (splits too); then K6's device time
    and bound share at level 0 and the last level of 2^25 and 2^27."""
    D = rt.datasets
    n = 1 << 25
    cases = [(ds.name, lambda ds=ds: rt.dtypes.signed_order(
                  rt.dtypes.to_sortable(rt.dtypes.tensor_from_numpy(
                      ds.generate(n), dev))))
             for ds in (D.RandomDistributed(np.uint32, seed=0),
                        D.Zeros(np.uint32), D.Range(np.uint32))]
    cases.append(("disjoint runs", lambda: disjoint_runs(n, cm.TILE, dev)))
    level_ms = {}
    for name, make in cases:
        x = make()
        tiles = cm.tile_sort(x)
        err = max_abs_err(tiles, cm.tile_sort_plain(x))
        require(err == 0, f"tile_sort on {name} disagrees")
        print(f"[kernels] tile_sort n={n} {name}: bit-exact", flush=True)
        level_in, cur = merge_levels(cm, tiles)
        require(bool((cur[1:] >= cur[:-1]).all()),
                f"merge levels on {name}: not sorted")
        last = len(level_in) - 1
        for level in (0, last):
            xin = level_in[level]
            got, splits = cm.merge_level(xin, level, with_splits=True)
            want_splits = cm.level_splits_plain(xin, level)
            err = max(max_abs_err(a, b) for a, b in zip(splits, want_splits))
            require(err == 0, f"merge_level {level} splits on {name} "
                              f"disagree")
            err = max_abs_err(got, cm.merge_level_plain(xin, *want_splits))
            require(err == 0, f"merge_level {level} on {name} disagrees")
            # the library call of the JSON line computes the same output
            err = max_abs_err(got, merge_level_library(cm, xin, level)
                              .values.reshape(-1))
            require(err == 0, f"torch.sort of level {level}'s pairs on "
                              f"{name} disagrees with merge_level")
            print(f"[kernels] merge_level n={n} level {level} {name} "
                  f"(splits + output, and torch.sort of the pairs): "
                  f"bit-exact", flush=True)
        if name == "RandomDistributed":
            note("tile_sort", 0, timings(lambda: cm.tile_sort(x),
                                         lambda: cm.tile_sort_plain(x)),
                 nbytes=8 * n,
                 library=lambda: torch.sort(x.view(-1, cm.TILE), dim=-1,
                                            stable=True))
            xin = level_in[last]
            note("merge_level", 0,
                 timings(lambda: cm.merge_level(xin, last),
                         lambda: cm.merge_level_plain(
                             xin, *cm.level_splits_plain(xin, last))),
                 nbytes=8 * n + 12 * (n // cm.TILE),
                 library=lambda: merge_level_library(cm, xin, last))
            level_ms[(25, last)] = res["merge_level"]["ms"]
            level_ms[(25, 0)] = device_ms(lambda: cm.merge_level(
                level_in[0], 0))
        del x, tiles, level_in, cur
    n27 = 1 << 27
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    x = torch.randint(-2**31, 2**31, (n27,), dtype=torch.int32, device=dev,
                      generator=gen)
    level_in, cur = merge_levels(cm, cm.tile_sort(x))
    require(bool((cur[1:] >= cur[:-1]).all()), "merge levels 2^27: not sorted")
    last27 = len(level_in) - 1
    for level in (0, last27):
        level_ms[(27, level)] = device_ms(
            lambda: cm.merge_level(level_in[level], level))
    del x, level_in, cur
    for (log2n, level), ms in sorted(level_ms.items()):
        b = bound_ms(8 * (1 << log2n) + 12 * ((1 << log2n) // cm.TILE))
        print(f"[kernels] merge_level 2^{log2n} level {level}: device "
              f"{ms:.5f} ms, bound {b:.5f} ms, share {b / ms:.3f}",
              flush=True)
    t = res["tile_sort"]
    print(f"[kernels] tile_sort 2^25: device {t['ms']:.5f} ms, bound "
          f"{t['bound_ms']:.5f} ms, share {t['bound_ms'] / t['ms']:.3f}; "
          f"plain {t['plain_ms']:.3f} ms; torch.sort of the tiles "
          f"{t['library_ms']:.3f} ms; merge_level plain "
          f"{res['merge_level']['plain_ms']:.3f} ms, torch.sort of the "
          f"pairs {res['merge_level']['library_ms']:.3f} ms", flush=True)


def merge_level_library(cm, x, level):
    """One PyTorch call that gives merge_level's output: a sort of each
    pair of runs of 2^level tiles (key-only int32, so the order is unique;
    the splits are a side output the sort never asks for)."""
    return torch.sort(x.view(-1, 2 * (cm.TILE << level)), dim=-1)


def merge_levels(cm, tiles):
    """Every merge level of a sort from sorted tiles: each level's input by
    level, and the sorted result."""
    level_in, cur = [], tiles
    for level in range((tiles.numel() // cm.TILE).bit_length() - 1):
        level_in.append(cur)
        cur, _ = cm.merge_level(cur, level)
    return level_in, cur


def narrow_keys(rt, n: int, dev):
    """``n`` uint8 and float16 RandomDistributed keys made on the card: the
    key planes of 8- and 16-bit sorts, the caller's own bits."""
    gen = rt.datasets_device.generate
    return (gen("RandomDistributed", np.uint8, n, seed=4, device=dev),
            gen("RandomDistributed", np.float16, n, seed=5, device=dev))


def phase_onesweep(dev, rt, cr, note, res):
    """The pass kernel in look-back mode against its plain version: a u32
    KV pass at 2^27 (RandomDistributed and Zeros), a u64 KV pass, the
    passes of u8 and f16 KV sorts on the caller's narrow key planes (and
    their base-table launches beyond 16 planes), a ragged n, 17 planes,
    the partition's pass (digit plane not moved), and the pass with 8-byte
    planes (phase_wide_pass)."""
    n = 1 << 27
    tile = rt.DEFAULT_CONFIG.tile_elems  # the sort's tile
    iota = torch.arange(n, dtype=torch.int32, device=dev)

    def check(what, digit, planes, radix=256, shift=0, kind="u"):
        counts = torch.bincount(cr._digits(digit, radix, shift, kind).long(),
                                minlength=radix).int()
        outs, _ = cr.onesweep_pass(digit, planes, counts, radix, tile, shift,
                                   kind=kind)
        want, _ = cr.onesweep_pass_plain(digit, planes, radix, tile, shift,
                                         kind=kind)
        err = max(max_abs_err(bits_of(a), bits_of(b))
                  for a, b in zip(outs, want))
        require(err == 0, f"onesweep_pass {what} disagrees")
        print(f"[kernels] onesweep_pass {what}: bit-exact", flush=True)
        return counts

    for ds in (rt.datasets.RandomDistributed(np.uint32, seed=0),
               rt.datasets.Zeros(np.uint32)):
        keys = rt.dtypes.tensor_from_numpy(ds.generate(n), dev).view(
            torch.int32)
        counts = check(f"u32 KV n=2^27 {ds.name} (pass 1, shift 8)", keys,
                       (keys, iota), shift=8)
        if ds.name == "RandomDistributed":
            t = timings(
                lambda: cr.onesweep_pass(keys, (keys, iota), counts, 256,
                                         tile, 8),
                lambda: cr.onesweep_pass_plain(keys, (keys, iota), 256,
                                               tile, 8))
            note("onesweep_pass", 0, t, nbytes=16 * n + 4 * 256)
            b = res["onesweep_pass"]["bound_ms"]
            print(f"[kernels] onesweep_pass u32 KV n=2^27: device "
                  f"{t['ms']:.5f} ms, {16 * n / t['ms'] / 1e9:.3f} TB/s of "
                  f"16 B an element; bound {b:.5f} ms, share "
                  f"{b / t['ms']:.3f} (of the 0.651 ms that counts a base "
                  f"table: {0.651 / t['ms']:.3f}); plain {t['plain_ms']:.3f} "
                  f"ms", flush=True)
        del keys
    ds = rt.datasets.RandomDistributed(np.uint64, seed=0)
    k64 = rt.dtypes.tensor_from_numpy(ds.generate(n), dev).view(torch.int32)
    lo, hi = k64[0::2].contiguous(), k64[1::2].contiguous()
    del k64
    check("u64 KV n=2^27 (lo, hi, payload; hi plane, shift 16)", hi,
          (lo, hi, iota), shift=16)
    del lo, hi
    k8, k16 = narrow_keys(rt, n, dev)
    for name, what, k, shift, kind, library in (
            ("onesweep_pass_8bit", "u8 KV n=2^27 (the one pass, shift 0)",
             k8, 0, "u", lambda: torch.sort(k8, stable=True)),
            ("onesweep_pass_16bit", "f16 KV n=2^27 (pass 2 of 2, shift 8)",
             k16, 8, "f", None)):
        counts = check(what, k, (k, iota), shift=shift, kind=kind)
        note(name, 0, timings(
            lambda: cr.onesweep_pass(k, (k, iota), counts, 256, tile, shift,
                                     kind=kind),
            lambda: cr.onesweep_pass_plain(k, (k, iota), 256, tile, shift,
                                           kind=kind)),
             nbytes=(2 * k.element_size() + 8) * n + 4 * 256,
             library=library)
        r = res[name]
        print(f"[kernels] {name} {what}: device {r['ms']:.5f} ms, bound "
              f"{r['bound_ms']:.5f} ms, share {r['bound_ms'] / r['ms']:.3f}; "
              f"plain {r['plain_ms']:.3f} ms", flush=True)
    check("f16 KV n=2^27 (pass 1 of 2, shift 0)", k16, (k16, iota),
          kind="f")
    m = (1 << 22) + 77
    check("f16 KV n=2^22+77 + 16 payload planes (base-table launch)",
          k16[:m], (k16[:m],) + tuple(iota[:m] + i for i in range(16)),
          shift=8, kind="f")
    check("u8 KV n=2^27-3 view off a 4-byte boundary", k8[3:],
          (k8[3:], iota[3:]))
    del k8, k16, counts
    phase_plan(dev, cr, tile, iota, note)
    m = n - 777
    x = torch.from_numpy(np.random.default_rng(1).integers(
        -2**31, 2**31, m).astype(np.int32)).to(dev)
    check(f"ragged n={m} (KV)", x, (x, iota[:m]), shift=24)
    check("17 planes n=2^22", x[:1 << 22],
          tuple(x[:1 << 22] + i for i in range(17)), radix=16, shift=4)
    ids = x & 255
    check("partition pass n=2^27-777 (ids not moved, 2 planes)", ids,
          (iota[:m], x))
    del x, ids
    phase_wide_pass(dev, rt, cr, note, res, check, iota)
    del iota


def phase_wide_pass(dev, rt, cr, note, res, check, iota):
    """The pass kernel's wide instance (some plane 8 bytes an element)
    against the plain version: a u32 key and an int64 payload at 2^27,
    timed beside its bound (24 B a row: each plane read and written once)
    and beside the same payload as two int32 word planes through the
    4-byte instance; then Q1's group-by compaction's planes (an int32 key,
    seven int64 columns, four int32 counts) at a ragged n on the 2^27 - 777
    tail, in look-back and base-table mode."""
    n = iota.numel()
    tile = rt.DEFAULT_CONFIG.tile_elems
    gen = rt.datasets_device.generate
    keys = gen("RandomDistributed", np.uint32, n, seed=6,
               device=dev).view(torch.int32)
    pay = gen("RandomDistributed", np.int64, n, seed=7, device=dev)
    counts = check("wide: u32 key + int64 payload n=2^27 (pass 1, shift 8)",
                   keys, (keys, pay), shift=8)
    nbytes = 24 * n + 4 * 256
    note("onesweep_pass_wide", 0, timings(
        lambda: cr.onesweep_pass(keys, (keys, pay), counts, 256, tile, 8),
        lambda: cr.onesweep_pass_plain(keys, (keys, pay), 256, tile, 8)),
         nbytes=nbytes)
    words = tuple(pay.view(torch.int32).view(n, 2)[:, w].contiguous()
                  for w in range(2))
    split = device_ms(lambda: cr.onesweep_pass(keys, (keys,) + words, counts,
                                               256, tile, 8))
    r = res["onesweep_pass_wide"]
    print(f"[kernels] onesweep_pass_wide u32 key + int64 payload n=2^27: "
          f"device {r['ms']:.5f} ms, bound {r['bound_ms']:.5f} ms, share "
          f"{r['bound_ms'] / r['ms']:.3f}; as two int32 word planes "
          f"{split:.5f} ms (share {r['bound_ms'] / split:.3f}); plain "
          f"{r['plain_ms']:.3f} ms", flush=True)
    del words
    m = n - 777
    k = keys[:m] & 0xFFFF  # the int32 key
    cols = tuple(pay[:m] * (3 + 2 * i) for i in range(7))
    cnts = tuple(iota[:m] + i for i in range(4))
    planes = (k,) + cols + cnts
    check(f"wide: Q1's compaction planes n={m} (int32 key, 7 int64, "
          f"4 int32; radix 16, shift 4)", k, planes, radix=16, shift=4)
    base = cr._stitch_block_base(cr.digit_histogram(k, 16, tile, 4))
    outs, _ = cr.rank_scatter(k, planes, base, 16, tile, 4)
    want, _ = cr.onesweep_pass_plain(k, planes, 16, tile, 4)
    err = max(max_abs_err(a, b) for a, b in zip(outs, want))
    require(err == 0, "rank_scatter wide (base-table mode) disagrees")
    note("onesweep_pass_wide", err)
    print(f"[kernels] rank_scatter wide: Q1's compaction planes n={m} in "
          f"base-table mode: bit-exact", flush=True)
    del keys, pay, k, cols, cnts, planes, base, outs, want


def phase_plan(dev, cr, tile: int, iota, note):
    """The sort's plan (csrc/radix.cu, ``Plan``) at u32 KV 2^27: the
    launches of a sort's passes, each holding IN, OUT and TMP bit for bit
    against the plain plan after it: a filled pass (it returns at once), a
    filled pass before a running one (pass 0 skips, pass 1 reads IN and
    writes OUT), and a sort that runs no pass (the last launch copies IN
    to OUT, whose storage is its own).  The filled pass's launch and the
    copy are timed."""
    n = iota.numel()
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    filled_first = (torch.randint(0, 1 << 23, (n,), dtype=torch.int32,
                                  device=dev, generator=gen) << 8) | 0x5A
    zeros = torch.zeros(n, dtype=torch.int32, device=dev)
    for what, keys, launches, want in (
            ("a filled pass (Zeros, pass 1 of 4)", zeros, (1,),
             [False] * 4),
            ("a filled pass before a running one (low byte filled; "
             "passes 0 and 1)", filled_first, (0, 1), [False] + [True] * 3),
            ("no pass runs (Zeros, passes 0-3: the last copies IN to OUT)",
             zeros, (0, 1, 2, 3), [False] * 4)):
        planes = (keys, iota)
        table = cr.pass_histograms((keys,), (4,), 256)
        runs = cr.plan_runs(table, (keys,), 4, 256)
        require(runs == want, f"plan of {what}: runs {runs}, want {want}")
        card, plain = ([planes] + [tuple(torch.zeros_like(q) for q in planes)
                                   for _ in range(2)] for _ in range(2))
        for p in launches:
            plan = cr.PassPlan(table, p, (keys,), 4, card[2])
            cr.onesweep_pass(keys, planes, table[p], 256, tile, 8 * p,
                             outs=card[1], plan=plan)
            cr.onesweep_pass_plain(keys, planes, 256, tile, 8 * p,
                                   plan=plan._replace(tmp=plain[2]),
                                   outs=plain[1])
        err = max(max_abs_err(a, b) for sa, sb in zip(card[1:], plain[1:])
                  for a, b in zip(sa, sb))
        held = {q.untyped_storage().data_ptr() for q in planes}
        require(err == 0 and not any(
            o.untyped_storage().data_ptr() in held for o in card[1]),
                f"onesweep_pass plan: {what} disagrees (max_abs_err {err}) "
                f"or OUT shares the input's storage")
        if len(launches) == 4:
            require(all(torch.equal(a, b) for a, b in zip(card[1], planes)),
                    f"{what}: OUT is not the input")
        note("onesweep_pass", err)
        print(f"[kernels] onesweep_pass plan u32 KV n=2^27, {what}: runs "
              f"{runs}; IN, OUT and TMP bit-exact against the plain plan "
              f"after each launch, OUT in its own storage", flush=True)
        del card, plain
    table = cr.pass_histograms((zeros,), (4,), 256)
    outs = (torch.empty_like(zeros), torch.empty_like(iota))

    def launch(p):
        return lambda: cr.onesweep_pass(
            zeros, (zeros, iota), table[p], 256, tile, 8 * p, outs=outs,
            plan=cr.PassPlan(table, p, (zeros,), 4, outs))

    skip, copy = device_ms(launch(1)), device_ms(launch(3))
    print(f"[kernels] onesweep_pass u32 KV n=2^27 on Zeros: a filled pass's "
          f"launch {skip:.5f} ms (every CTA returns after the plan); the "
          f"last launch's copy of IN to OUT {copy:.5f} ms, bound "
          f"{bound_ms(16 * n):.5f} ms", flush=True)


def sort_args(rt, keys, npay: int, dev):
    """sort_passes' (key planes, passes, payload planes, kind) for a radix
    256 sort of ``keys`` with ``npay`` int32 payload planes, as the sort
    entry points build them."""
    from radix_sort_tpu_torch.ops import stream

    n = keys.numel()
    d = rt.dtypes.key_dtype(keys.dtype)
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    pays = tuple(iota * (2 * i + 1) for i in range(npay))
    if d.itemsize < 4:
        return (rt.dtypes.as_container(keys),), (d.itemsize,), pays, d.kind
    kp = stream.key_word_planes(rt.dtypes.to_sortable(keys))
    return kp, (4,) * len(kp), pays, "u"


def phase_enqueue(dev, rt, cr):
    """[enqueue] ``sort_passes``, a whole sort or partition in one call into
    the kernel library (``rst_sort_planes``), bit for bit against the
    per-pass launches (``sort_passes_plain`` on the same card tensors, with
    the same launch counts) and against the plain torch version
    (``torch_only``): u32 key-only 2^20, u32 KV 2^27 on RandomDistributed
    and Zeros, u64 KV 2^24, u8 and f16 KV 2^27, a 17-plane KV (u32 keys and
    16 payloads at 2^24: a base-table launch a pass) and partitions of 2^26
    rows at 256 and 1000 buckets.  Then config 1's sort beside torch.sort
    and config 4 beside engine="torch_sort": one call's ms, the host's
    enqueue µs and, for config 1, the device ms a call back to back."""
    gen = rt.datasets_device.generate
    tile = rt.DEFAULT_CONFIG.tile_elems

    def counts():
        return {**cr.launch_counts(), **cr.narrow_launch_counts()}

    cases = [("u32 key-only 2^20 RandomDistributed", np.uint32,
              "RandomDistributed", 20, 0)]
    cases += [(f"u32 KV 2^27 {d}", np.uint32, d, 27, 1)
              for d in ("RandomDistributed", "Zeros")]
    cases += [("u64 KV 2^24 RandomDistributed", np.uint64,
               "RandomDistributed", 24, 1),
              ("u8 KV 2^27 RandomDistributed", np.uint8,
               "RandomDistributed", 27, 1),
              ("f16 KV 2^27 RandomDistributed", np.float16,
               "RandomDistributed", 27, 1),
              ("17-plane KV 2^24 (u32 keys, 16 payloads)", np.uint32,
               "RandomDistributed", 24, 16)]
    for what, dtype, dist, log2n, npay in cases:
        keys = gen(dist, dtype, 1 << log2n, seed=11, device=dev)
        kp, passes, pays, kind = sort_args(rt, keys, npay, dev)
        enqueue_check(cr, what, counts, (kp, passes, pays, 256, tile),
                      {"kind": kind})
        del keys, kp, pays
    gen_ids = torch.Generator(device=dev)
    gen_ids.manual_seed(12)
    n = 1 << 26
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    for buckets in (256, 1000):
        ids = torch.randint(0, buckets, (n,), dtype=torch.int32, device=dev,
                            generator=gen_ids)
        planes = (iota, iota * 3)
        if buckets <= 256:
            args, kw = ((), (1,), planes, 256, tile), {"digit": ids}
        else:  # two moving 8-bit passes over the ids, as partition_planes
            args, kw = ((ids,), (2,), planes, 256, tile), {}
        enqueue_check(cr, f"partition 2^26 rows, {buckets} buckets", counts,
                      args, kw)
        del ids, planes
    del iota

    keys = rt.dtypes.tensor_from_numpy(
        rt.datasets.RandomDistributed(np.uint32, seed=0).generate(1 << 20),
        dev)
    row = {}
    for name, fn in (("radix", lambda: rt.sort(keys)),
                     ("torch.sort", lambda: rt.sort(keys,
                                                    engine="torch_sort"))):
        row[name] = (time_ms(fn), enqueue_us(fn), device_ms(fn))
    print("[enqueue] config 1, sort u32 2^20: " + "; ".join(
        f"{name} one call {one:.4f} ms, host enqueue {enq:.1f} us, device "
        f"{dms:.4f} ms a call back to back"
        for name, (one, enq, dms) in row.items()), flush=True)
    tbc = script("torch_baseline_configs")
    (_, r), = tbc.config4(dev, 20)
    require(r["valid"], "[enqueue] config 4: differs from numpy")
    pcols, bcols = tbc.config4_inputs(20)
    probe = rt.Table.from_numpy(pcols, device=dev)
    build = rt.Table.from_numpy(bcols, device=dev)
    enq = {name: enqueue_us(lambda: tbc.config4_query(probe, build, cfg))
           for name, cfg in (("radix", rt.DEFAULT_CONFIG),
                             ("torch_sort",
                              rt.SortConfig(engine="torch_sort")))}
    print(f"[enqueue] config 4, join 2^20 x 2^18: radix one call "
          f"{r['ms']:.4f} ms, host enqueue {enq['radix']:.1f} us; "
          f"engine=torch_sort one call {r['torch_sort_ms']:.4f} ms, host "
          f"enqueue {enq['torch_sort']:.1f} us", flush=True)


def enqueue_check(cr, what: str, counts, args, kw):
    """sort_passes(*args, **kw) against sort_passes_plain's per-pass
    launches and its torch_only version: OUT and the pass table bit for
    bit, the same launch counts."""
    c0 = counts()
    outs, table = cr.sort_passes(*args, **kw)
    c1 = counts()
    per, per_table = cr.sort_passes_plain(*args, **kw)
    c2 = counts()
    plain, plain_table = cr.sort_passes_plain(*args, **kw, torch_only=True)
    fused = {k: c1[k] - c0[k] for k in c0}
    require(fused == {k: c2[k] - c1[k] for k in c0},
            f"[enqueue] {what}: launches {fused} differ from the per-pass "
            f"path's")
    err = max(max_abs_err(bits_of(a), bits_of(b))
              for want in (per, plain) for a, b in zip(outs, want))
    err = max(err, max_abs_err(table, per_table),
              max_abs_err(table, plain_table))
    require(err == 0, f"[enqueue] {what}: max_abs_err {err}")
    print(f"[enqueue] {what}: sort_passes bit-exact against the per-pass "
          f"launches and the plain version (max_abs_err 0); launches "
          f"{ {k: v for k, v in fused.items() if v} }", flush=True)
    del outs, per, plain


def check_sorted_kv(rt, keys_in, keys_out, perm, host_keys, what,
                    oracle=np.sort):
    """On the device: sorted, same key multiset (sum + xor), payload is the
    permutation that produced the keys, stable within equal keys.  On the
    host: a 2^20 prefix against ``oracle(host_keys)`` (np.sort).  Sums and
    xors run on the sortable bits, a bijection of the keys that floats
    have too."""
    bi = rt.dtypes.to_sortable(keys_in)
    bo = rt.dtypes.to_sortable(keys_out)
    so = rt.dtypes.signed_order(bo)
    require(bool((so[1:] >= so[:-1]).all()), f"{what}: not sorted")
    require(int(bi.sum()) == int(bo.sum()), f"{what}: key sum differs")
    require(xor_reduce(bi) == xor_reduce(bo), f"{what}: key xor differs")
    if perm is not None:
        require(bool((bi[perm.to(torch.int64)] == bo).all()),
                f"{what}: keys_in[payload] != keys_out")
        tie = bo[1:] == bo[:-1]
        require(bool((~tie | (perm[1:] > perm[:-1])).all()),
                f"{what}: not stable")
    pre = 1 << 20
    host = rt.dtypes.tensor_to_numpy(keys_out[:pre])
    require(np.array_equal(host.view(np.uint8),
                            oracle(host_keys)[:pre].view(np.uint8)),
            f"{what}: 2^20 prefix differs from np.sort")


def phase_sort(dev, rt):
    results = []
    cases = [(ds, 27, True) for ds in rt.datasets.make_datasets(np.uint32, 0)]
    cases += [(rt.datasets.RandomDistributed(np.uint64, seed=0), 27, True),
              (rt.datasets.RandomDistributed(np.uint32, seed=0), 25, False)]
    for ds, log2n, kv in cases:
        n = 1 << log2n
        host = ds.generate(n)
        keys = rt.dtypes.tensor_from_numpy(host, dev)
        what = f"{'sort_kv' if kv else 'sort'} {host.dtype.name} {ds.name} " \
               f"2^{log2n}"
        if kv:
            iota = torch.arange(n, dtype=torch.int32, device=dev)
            ko, perm = rt.sort_kv(keys, iota)
            run = lambda: rt.sort_kv(keys, iota)  # noqa: E731
            base = lambda: rt.sort_kv(keys, iota, engine="torch_sort")  # noqa
        else:
            ko, perm = rt.sort(keys), None
            run = lambda: rt.sort(keys)  # noqa: E731
            base = lambda: rt.sort(keys, engine="torch_sort")  # noqa: E731
        check_sorted_kv(rt, keys, ko, perm, host, what)
        ms, ms_t = time_ms(run), time_ms(base)
        unit = "Mpairs/s" if kv else "Mkeys/s"
        print(f"[sort] {what}: validated; radix {ms:.3f} ms "
              f"({n / ms / 1e3:.1f} {unit}), torch.sort {ms_t:.3f} ms "
              f"({n / ms_t / 1e3:.1f} {unit})", flush=True)
        results.append((what, ms, ms_t))
        del keys, ko, perm
    return results


# (dtype, dataset) of the [dtypes] phase's 2^27 KV sorts
NARROW_SORTS = ((np.uint8, "RandomDistributed"), (np.uint8, "Zeros"),
                (np.int8, "RandomDistributed"),
                (np.float16, "RandomDistributed"))


def counting_sort(rt, host: np.ndarray) -> np.ndarray:
    """1- and 2-byte keys in the sort's order, by counting their sortable
    images (np.sort of float16 at 2^27 takes seconds)."""
    img = rt.dtypes.np_to_sortable_unsigned(host)
    counts = np.bincount(img, minlength=1 << (8 * host.itemsize))
    return rt.dtypes.np_from_sortable_unsigned(
        np.repeat(np.arange(counts.size, dtype=img.dtype), counts),
        host.dtype)


def untransformed(rt, fn):
    """fn() with ``dtypes.to_sortable`` / ``from_sortable`` counted: returns
    (fn's result, how many times either ran)."""
    calls = []
    saved = rt.dtypes.to_sortable, rt.dtypes.from_sortable

    def counted(f):
        def run(*a, **kw):
            calls.append(f.__name__)
            return f(*a, **kw)
        return run

    rt.dtypes.to_sortable, rt.dtypes.from_sortable = map(counted, saved)
    try:
        return fn(), len(calls)
    finally:
        rt.dtypes.to_sortable, rt.dtypes.from_sortable = saved


def phase_dtypes(dev, rt):
    """uint8, int8 and float16 KV sorts at 2^27 on the narrow pass (the
    caller's key bits at their own width, no transform and no int32 key
    plane), key-only sort and argsort beside them, and a Query over narrow
    columns at 2^26 (phase_dtypes_query)."""
    n = 1 << 27
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    for dtype, name in NARROW_SORTS:
        d = np.dtype(dtype)
        keys = rt.datasets_device.generate(name, d, n, seed=9, device=dev)
        host = rt.dtypes.tensor_to_numpy(keys)
        what = f"sort_kv {d.name} {name} 2^27"
        before = launch_counts()
        (ko, perm), transforms = untransformed(
            rt, lambda: rt.sort_kv(keys, iota))
        torch.cuda.synchronize()
        after = launch_counts()
        bits = 8 * d.itemsize
        names = ("pass_histograms", "onesweep_pass",
                 f"pass_histograms_{bits}bit", f"onesweep_pass_{bits}bit")
        launched = {k: after[k] - before[k] for k in names}
        passes = d.itemsize  # launched, filled or not (Zeros: none runs)
        want_launches = dict(zip(names, (1, passes, 1, passes)))
        require(launched == want_launches,
                f"{what}: launches {launched}, want {want_launches}: 1 "
                f"pass_histograms and {passes} onesweep_pass, all with the "
                f"{bits}-bit key plane")
        require(transforms == 0, f"{what}: the key went through "
                                 f"to_sortable / from_sortable")
        want = counting_sort(rt, host)
        check_sorted_kv(rt, keys, ko, perm, host, what,
                        oracle=lambda _: want)
        require(np.array_equal(rt.dtypes.tensor_to_numpy(ko).view(np.uint8),
                               want.view(np.uint8)),
                f"{what}: keys differ from the counting sort")
        require(bool((bits_of(rt.sort(keys)) == bits_of(ko)).all()),
                f"{what}: sort differs from sort_kv's keys")
        require(bool((rt.argsort(keys) == perm).all()),
                f"{what}: argsort differs from sort_kv's payload")
        ms = time_ms(lambda: rt.sort_kv(keys, iota))
        ms_s = time_ms(lambda: rt.sort(keys))
        ms_a = time_ms(lambda: rt.argsort(keys))
        ms_t = time_ms(lambda: rt.sort_kv(keys, iota, engine="torch_sort"))
        ms_b = time_ms(lambda: torch.sort(keys, stable=True))
        print(f"[dtypes] {what}: validated (every key vs a counting sort, "
              f"payload stable, sort and argsort equal); launches "
              f"{launched}; no to_sortable / from_sortable; radix {ms:.3f} "
              f"ms ({n / ms / 1e3:.1f} Mpairs/s), sort {ms_s:.3f} ms, "
              f"argsort {ms_a:.3f} ms, engine torch_sort {ms_t:.3f} ms "
              f"({n / ms_t / 1e3:.1f} Mpairs/s), bare torch.sort {ms_b:.3f} "
              f"ms ({n / ms_b / 1e3:.1f} Mpairs/s)", flush=True)
        del keys, ko, perm
    del iota
    phase_dtypes_query(dev, rt)


def phase_dtypes_query(dev, rt):
    """A Query over 2^26 rows (4099 padding) with narrow columns: group_by
    a uint8 key (count, sum of int32, min/max of float16) against numpy
    over every group; top_k of the float16 column (ties to the earlier
    row) against a numpy selection; a window over 4096-row partitions
    ordered by an int8 key (row_number, rank, cum_sum, first_value of the
    float16 column) against a numpy lexsort oracle on the first 2^20 rows,
    and its row numbers by checksum over every full partition.  Each
    timed beside engine="torch_sort"."""
    n = 1 << 26
    m = n - PADDING
    gen = rt.datasets_device.generate
    cols = {"g": gen("RandomDistributed", np.uint8, n, seed=11, device=dev),
            "h": gen("RandomDistributed", np.float16, n, seed=12,
                     device=dev),
            "o": gen("RandomDistributed", np.int8, n, seed=13, device=dev),
            "p": (torch.arange(n, device=dev) >> 12).to(torch.int32),
            "x": torch.randint(-100, 100, (n,), dtype=torch.int32,
                               device=dev),
            "row": torch.arange(n, dtype=torch.int32, device=dev)}
    t = rt.Table(cols, num_rows=m)
    host = {k: rt.dtypes.tensor_to_numpy(v[:m]) for k, v in cols.items()}

    def group(config=rt.DEFAULT_CONFIG):
        return rt.Query(t, config).group_by(
            "g", n=("count", None), s=("sum", "x"), lo=("min", "h"),
            hi=("max", "h")).collect()

    order = np.argsort(host["g"], kind="stable")
    counts = np.bincount(host["g"], minlength=256)
    starts = (np.cumsum(counts) - counts)[counts > 0]
    hs = host["h"][order]
    want = {"g": np.nonzero(counts)[0].astype(np.uint8),
            "n": counts[counts > 0].astype(np.int32),
            "s": np.bincount(host["g"], weights=host["x"],
                             minlength=256)[counts > 0].astype(np.int32),
            "lo": np.minimum.reduceat(hs, starts),
            "hi": np.maximum.reduceat(hs, starts)}
    got = group().to_numpy()
    for k, w in want.items():
        require(np.array_equal(got[k].view(np.uint8), w.view(np.uint8)),
                f"dtypes query: group_by column {k} differs")

    k_top = 1000

    def top(config=rt.DEFAULT_CONFIG):
        return rt.Query(t, config).top_k("h", k_top).collect()

    img = rt.dtypes.np_to_sortable_unsigned(host["h"]).astype(np.int64)
    kth = np.partition(img, m - k_top)[m - k_top]
    cand = np.nonzero(img >= kth)[0]
    best = cand[np.lexsort((cand, -img[cand]))][:k_top]
    got = top().to_numpy()
    require(np.array_equal(got["row"], best.astype(np.int32))
            and np.array_equal(got["h"].view(np.uint8),
                               host["h"][best].view(np.uint8)),
            "dtypes query: top_k rows differ")

    def window(config=rt.DEFAULT_CONFIG):
        return rt.Query(t, config).window(
            "p", "o", rn=("row_number",), rk=("rank",), s=("cum_sum", "x"),
            fv=("first_value", "h")).collect()

    out = window()
    pre = 1 << 20  # 256 whole partitions
    p, o = host["p"][:pre], host["o"][:pre]
    srt = np.lexsort((np.arange(pre), o, p))
    ps, os_ = p[srt], o[srt]
    start = np.searchsorted(ps, ps)
    rn = np.arange(pre) - start + 1
    tie = np.r_[True, (ps[1:] != ps[:-1]) | (os_[1:] != os_[:-1])]
    rk = rn[np.maximum.accumulate(np.where(tie, np.arange(pre), 0))]
    cs = np.cumsum(host["x"][:pre][srt].astype(np.int64))
    s = cs - cs[start] + host["x"][:pre][srt][start]
    fv = host["h"][:pre][srt][start]
    for name, w in (("rn", rn), ("rk", rk), ("s", s), ("fv", fv)):
        want = np.empty_like(w)
        want[srt] = w
        got = rt.dtypes.tensor_to_numpy(out[name][:pre])
        require(np.array_equal(got.view(np.uint8),
                               want.astype(got.dtype).view(np.uint8)),
                f"dtypes query: window {name} differs on the first 2^20 "
                f"rows")
    full = m >> 12  # partitions with no padding row
    require(int(out["rn"][:full << 12].sum()) == full * 4096 * 4097 // 2,
            "dtypes query: window row numbers' checksum differs")
    del out
    times = [beside_torch_sort(rt, fn) for fn in (group, top, window)]
    print(f"[dtypes] Query over 2^26 rows ({PADDING} padding): group_by "
          f"uint8 (count, sum, min/max float16; 256 groups vs numpy) "
          f"{times[0][0]:.3f} ms ({n / times[0][0] / 1e3:.1f} Mrows/s), with "
          f"torch.sort {times[0][1]:.3f} ms; top_k float16 k={k_top} "
          f"{times[1][0]:.3f} ms, with torch.sort {times[1][1]:.3f} ms; "
          f"window over 4096-row partitions ordered by int8 "
          f"{times[2][0]:.3f} ms ({n / times[2][0] / 1e3:.1f} Mrows/s), "
          f"with torch.sort {times[2][1]:.3f} ms: validated", flush=True)
    del t, cols


PROFILE_SESSIONS = 6


def _profile(fn, iters: int, complete=lambda rows: True) -> list:
    """Device-side profiler events of ``iters`` calls of ``fn``.  A session
    counts if it recorded device time and ``complete(rows)`` holds.
    torch.profiler on an H100 now and then returns a profiling session
    short of rows (none at all, or 16 of a merge sort's 33 merge_level
    rows), sometimes several in a row; such a session is printed and
    taken again after a pause, PROFILE_SESSIONS at most."""
    for attempt in range(1, PROFILE_SESSIONS + 1):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if rows and complete(rows):
            return rows
        print(f"[profile] torch.profiler session {attempt}: {len(rows)} "
              f"device rows, short; profiling again", flush=True)
        torch.cuda.empty_cache()
        time.sleep(1.0)
    require(False, f"torch.profiler short in {PROFILE_SESSIONS} sessions")


def _ms(rows, iters: int, pred=lambda e: True) -> float:
    return sum(e.device_time_total for e in rows if pred(e)) / iters / 1e3


def phase_profile(dev, rt):
    """A u32 KV sort at 2^27: its launches and host reads (one
    pass_histograms, four onesweep passes, no read), and torch.profiler's
    device time a sort by kernel.  Then the card's idle share over
    back-to-back u32 key-only sorts at 2^25: 1 - (profiled device time) /
    (event time of the same loop without the profiler)."""
    from radix_sort_tpu_torch.ops import stream

    n = 1 << 27
    keys = rt.dtypes.tensor_from_numpy(
        rt.datasets.RandomDistributed(np.uint32, seed=0).generate(n), dev)
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    rt.sort_kv(keys, iota)
    torch.cuda.synchronize()
    before, reads = launch_counts(), stream.host_reads
    rt.sort_kv(keys, iota)
    torch.cuda.synchronize()
    delta = {k: v - before[k] for k, v in launch_counts().items()}
    want = {"pass_histograms": 1, "onesweep_pass": 4, "digit_histogram": 0,
            "exclusive_scan": 0, "rank_scatter": 0}
    require(all(delta[k] == v for k, v in want.items()),
            f"a u32 KV 2^27 sort launched {delta}, expected {want}")
    require(stream.host_reads - reads == 0, "a sort read the host "
            f"{stream.host_reads - reads} times")
    iters = 3
    rows = _profile(lambda: rt.sort_kv(keys, iota), iters)
    total = _ms(rows, iters)
    hist = _ms(rows, iters, lambda e: "pass_histograms_kernel" in e.name)
    passes = _ms(rows, iters, lambda e: "rank_scatter_kernel" in e.name)
    memset = _ms(rows, iters, lambda e: e.name.startswith("Memset"))
    print(f"[profile] sort_kv u32 RandomDistributed 2^27: device "
          f"{total:.4f} ms a sort: pass_histograms {hist:.4f}, 4 onesweep "
          f"passes {passes:.4f} ({passes / 4:.4f} each), memsets "
          f"{memset:.4f}, other {total - hist - passes - memset:.4f}; "
          f"launches {delta}; host reads a sort 0", flush=True)
    del keys, iota

    n = 1 << 25
    keys = rt.dtypes.tensor_from_numpy(
        rt.datasets.RandomDistributed(np.uint32, seed=0).generate(n), dev)
    sorts = 10

    def loop():
        for _ in range(sorts):
            rt.sort(keys)

    wall = time_ms(loop) / sorts
    busy = _ms(_profile(loop, 1), sorts)
    print(f"[profile] sort u32 key-only 2^25, {sorts} back to back: "
          f"{wall:.4f} ms a sort (events), device busy {busy:.4f} ms, idle "
          f"share {1 - busy / wall:.4f}", flush=True)


# the [nosync] phase's sizes: the sorts' (log2), then the partition's and
# compaction's rows, config 3's (log2) and config 4's probe (log2)
NOSYNC_SORTS = (20, 27)
NOSYNC_ROWS = 1 << 26
NOSYNC_CONFIGS = (26, 20)


def no_sync(what: str, fn):
    """fn() under torch.cuda.set_sync_debug_mode("error"): a host sync
    inside raises (the mode is reset to its old value, the error kept)."""
    torch.cuda.synchronize()
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    except RuntimeError as e:
        raise SmokeFailure(f"[nosync] {what}: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode(old)
    torch.cuda.synchronize()
    return out


def phase_nosync(dev, rt):
    """Each operation once under torch.cuda.set_sync_debug_mode("error"),
    so any host sync fails the run: sort, sort_kv and argsort of u32, u64,
    u8 and f16 keys at 2^20 and 2^27 on RandomDistributed and Zeros (the
    Zeros sorts copy in their last launch), a 1000-bucket
    stable_partition(method="stream"), compact_mask(method="stream"),
    config 3's filter -> aggregate and config 4's join.  Inputs are made
    before the mode is set; the sorts and the partition are checked on the
    card after it."""
    from radix_sort_tpu_torch.ops import partition

    tbc = script("torch_baseline_configs")
    done = []
    for log2n in NOSYNC_SORTS:
        n = 1 << log2n
        iota = torch.arange(n, dtype=torch.int32, device=dev)
        for dtype in (np.uint32, np.uint64, np.uint8, np.float16):
            for name in ("RandomDistributed", "Zeros"):
                keys = rt.datasets_device.generate(name, dtype, n, seed=7,
                                                   device=dev)
                what = f"{np.dtype(dtype).name} {name} 2^{log2n}"
                ks = no_sync(f"sort {what}", lambda: rt.sort(keys))
                ko, perm = no_sync(f"sort_kv {what}",
                                   lambda: rt.sort_kv(keys, iota))
                pa = no_sync(f"argsort {what}", lambda: rt.argsort(keys))
                so = rt.dtypes.signed_order(rt.dtypes.to_sortable(ko))
                c = rt.dtypes.as_container
                require(bool((so[1:] >= so[:-1]).all())
                        and torch.equal(bits_of(c(ks)), bits_of(c(ko)))
                        and torch.equal(pa, perm)
                        and torch.equal(bits_of(c(keys)[perm.long()]),
                                        bits_of(c(ko))),
                        f"[nosync] {what}: sort, sort_kv and argsort "
                        f"disagree or are not sorted")
                done.append(f"sort/sort_kv/argsort {what}")
                del keys, ks, ko, perm, pa, so
        del iota
    n = NOSYNC_ROWS
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    ids = torch.randint(0, 1000, (n,), dtype=torch.int32, device=dev,
                        generator=gen)
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    (out,), counts, _ = no_sync(
        f"stable_partition 1000 buckets, {n} rows",
        lambda: partition.stable_partition(ids, (iota,), 1000,
                                           method="stream"))
    srt = torch.sort(ids, stable=True)
    require(torch.equal(out, srt.indices.to(torch.int32))
            and int(counts.sum()) == n,
            "[nosync] stable_partition: not the stable partition")
    mask = (ids & 1) == 0
    for label, m in (("mixed", mask), ("all kept", torch.ones_like(mask))):
        (co,), kept = no_sync(f"compact_mask {label}, {n} rows",
                              lambda: partition.compact_mask(
                                  m, (iota,), method="stream"))
        want = torch.nonzero(m).view(-1).to(torch.int32)
        require(torch.equal(co[:want.numel()], want)
                and int(kept) == want.numel(),
                f"[nosync] compact_mask {label}: wrong rows")
    done += [f"stable_partition 1000 buckets, {n} rows",
             f"compact_mask mixed and all kept, {n} rows"]
    del ids, iota, out, counts, srt, mask, co
    log3, log4 = NOSYNC_CONFIGS
    t3 = rt.Table.from_numpy(tbc.config3_inputs(log3), device=dev)
    r3 = no_sync(f"config 3 filter -> aggregate 2^{log3}",
                 lambda: tbc.config3_query(t3, rt.DEFAULT_CONFIG))
    pcols, bcols = tbc.config4_inputs(log4)
    probe = rt.Table.from_numpy(pcols, device=dev)
    build = rt.Table.from_numpy(bcols, device=dev)
    r4, stats = no_sync(f"config 4 join 2^{log4}",
                        lambda: tbc.config4_query(probe, build,
                                                  rt.DEFAULT_CONFIG))
    k3 = t3.to_numpy()["k"]
    want3 = np.bincount(k3[k3 < 500], minlength=500)
    require(np.array_equal(r3.to_numpy()["n"], want3[want3 > 0]),
            "[nosync] config 3: wrong counts")
    require(int(stats["match_count"]) == int(np.isin(pcols["k"],
                                                      bcols["k"]).sum()),
            "[nosync] config 4: wrong match count")
    done += [f"config 3 filter -> aggregate 2^{log3}",
             f"config 4 join 2^{log4}"]
    print(f"[nosync] no host sync (torch.cuda.set_sync_debug_mode('error')) "
          f"in: {'; '.join(done)}", flush=True)


def phase_merge_profile(dev, rt):
    """A u32 key-only merge sort at 2^25 and 2^27: its launches (one
    tile_sort and one merge_level a level, and no other kernel of the
    package), torch.profiler's device time a sort by kernel (no split
    kernel among the rows) and the idle share over back-to-back sorts."""
    for log2n in (25, 27):
        n = 1 << log2n
        levels = (n // 16384).bit_length() - 1
        keys = rt.dtypes.tensor_from_numpy(
            rt.datasets.RandomDistributed(np.uint32, seed=0).generate(n), dev)
        run = lambda: rt.sort(keys, engine="merge")  # noqa: E731
        run()
        torch.cuda.synchronize()
        before = launch_counts()
        run()
        torch.cuda.synchronize()
        delta = {k: v - before[k] for k, v in launch_counts().items()}
        want = {k: 0 for k in delta}
        want.update(tile_sort=1, merge_level=levels)
        require(delta == want, f"a merge sort of 2^{log2n} launched {delta}, "
                               f"expected {want}")
        iters = 3

        def merge_rows(rows):
            return [e for e in rows if "merge_level_kernel" in e.name]

        rows = _profile(run, iters,
                        lambda rows: len(merge_rows(rows)) == levels * iters)
        names = {e.name for e in rows}
        require(not any("split" in name for name in names),
                f"a split kernel ran: {sorted(names)}")
        merges = merge_rows(rows)
        require(len(merges) == levels * iters,
                f"{len(merges)} merge_level_kernel rows in {iters} sorts of "
                f"{levels} levels")
        total = _ms(rows, iters)
        tsort = _ms(rows, iters, lambda e: "tile_sort_kernel" in e.name)
        merge = _ms(merges, iters)
        sorts = 10

        def loop():
            for _ in range(sorts):
                run()

        wall = time_ms(loop) / sorts
        busy = _ms(_profile(loop, 1), sorts)
        print(f"[profile] sort u32 key-only engine=merge 2^{log2n}: device "
              f"{total:.4f} ms a sort: tile_sort {tsort:.4f}, {levels} "
              f"merge_level {merge:.4f} ({merge / levels:.4f} each), glue "
              f"{total - tsort - merge:.4f}; launches {delta}; {sorts} back "
              f"to back: {wall:.4f} ms a sort (events), device busy "
              f"{busy:.4f} ms, idle share {1 - busy / wall:.4f}", flush=True)
        del keys


def phase_config3(dev, rt):
    """BASELINE config 3 at 2^26 rows, as scripts/torch_baseline_configs.py
    runs and checks it: filter(k < 500) -> hash_aggregate(count, sum)
    against np.bincount, beside its sorts on torch.sort."""
    (name, r), = script("torch_baseline_configs").config3(dev, 26)
    require(r["valid"], f"{name}: differs from np.bincount")
    print(f"[config3] filter(k<500) -> aggregate(count,sum) 2^26 rows: "
          f"validated vs np.bincount; {r['ms']:.3f} ms ({r['mrows_per_s']} "
          f"Mrows/s); with torch.sort inside {r['torch_sort_ms']:.3f} ms "
          f"({r['torch_sort_mrows_per_s']} Mrows/s)", flush=True)
    return r["ms"], r["torch_sort_ms"]


def phase_config4(dev, rt):
    """BASELINE config 4 with a 2^20-row probe and a 2^18-row unique
    build, as scripts/torch_baseline_configs.py runs and checks it, beside
    its sorts on torch.sort."""
    (name, r), = script("torch_baseline_configs").config4(dev, 20)
    require(r["valid"], f"{name}: differs from numpy")
    print(f"[config4] hash_join 2^20 probe x 2^18 build: validated "
          f"({r['matches']} matches); {r['ms']:.3f} ms ({r['mrows_per_s']} "
          f"Mrows/s); with torch.sort inside {r['torch_sort_ms']:.3f} ms "
          f"({r['torch_sort_mrows_per_s']} Mrows/s)", flush=True)
    return r["ms"], r["torch_sort_ms"]


def phase_merge(dev, rt):
    """Key-only sorts under engine="merge", timed beside radix and
    torch.sort."""
    D = rt.datasets
    cases = [(ds, 1 << 25) for ds in D.make_datasets(np.uint32, 0)]
    cases += [(D.RandomDistributed(np.int32, seed=0), 1 << 25),
              (D.RandomDistributed(np.float32, seed=0), 1 << 25),
              (D.RandomDistributed(np.uint32, seed=1), (1 << 25) - 777),
              (D.RandomDistributed(np.uint32, seed=2), 1 << 27)]
    results = []
    for ds, n in cases:
        host = ds.generate(n)
        keys = rt.dtypes.tensor_from_numpy(host, dev)
        what = f"sort {host.dtype.name} {ds.name} n={n}"
        check_sorted_kv(rt, keys, rt.sort(keys, engine="merge"), None, host,
                        what)
        ms = {e: time_ms(lambda: rt.sort(keys, engine=e))
              for e in ("merge", "radix", "torch_sort")}
        print(f"[merge] {what}: validated; merge {ms['merge']:.3f} ms "
              f"({n / ms['merge'] / 1e3:.1f} Mkeys/s), radix "
              f"{ms['radix']:.3f} ms, torch.sort {ms['torch_sort']:.3f} ms",
              flush=True)
        results.append((what, ms))
        del keys
    return results


def phase_topk(dev, rt):
    """top_k on both paths (large k under engine="merge") and top_k_kv with
    heavy ties, against numpy's stable order."""
    n = 1 << 25
    host = rt.datasets.RandomDistributed(np.uint32, seed=5).generate(n)
    keys = rt.dtypes.tensor_from_numpy(host, dev)
    best = np.sort(host)[::-1]
    merge_cfg = rt.SortConfig(engine="merge")
    for k, cfg in ((1 << 24, merge_cfg), (1024, rt.DEFAULT_CONFIG)):
        got = rt.dtypes.tensor_to_numpy(rt.top_k(keys, k, config=cfg))
        require(np.array_equal(got, best[:k]), f"top_k k={k} differs")
        ms = time_ms(lambda: rt.top_k(keys, k, config=cfg))
        print(f"[topk] top_k u32 n={n} k={k} engine={cfg.engine}: validated "
              f"vs np.sort; {ms:.3f} ms", flush=True)
    del keys
    tied = np.random.default_rng(6).integers(0, 8, n).astype(np.uint32)
    keys = rt.dtypes.tensor_from_numpy(tied, dev)
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    order = np.argsort(-tied.astype(np.int64), kind="stable")
    for k in (1024, 1 << 24):
        ko, po = rt.top_k_kv(keys, iota, k)
        require(np.array_equal(po.cpu().numpy(), order[:k]),
                f"top_k_kv k={k}: payload is not numpy's stable order")
        require(np.array_equal(rt.dtypes.tensor_to_numpy(ko),
                               tied[order[:k]]), f"top_k_kv k={k}: keys")
        ms = time_ms(lambda: rt.top_k_kv(keys, iota, k))
        print(f"[topk] top_k_kv u32 integers(0, 8) n={n} k={k}: validated vs "
              f"numpy stable argsort; {ms:.3f} ms", flush=True)


def phase_harness(dev, rt):
    """The reference's harness on the card: run_all at 2^22, a key-only
    merge task at 2^25, the per-phase columns; every row valid."""
    from radix_sort_tpu_torch import harness
    from radix_sort_tpu_torch.utils import cli, csvio

    t0 = time.perf_counter()
    results = harness.run_all(
        cli.RadixSortOptions(num_elements=1 << 22, iterations=2), device=dev)
    require(len(results) == 20, f"run_all gave {len(results)} rows")
    bad = [(r.row.datatype, r.row.dataset) for r in results if not r.valid]
    require(not bad, f"run_all rows not valid: {bad}")
    print(f"[harness] run_all u32/i32/u64/i64 x 5 datasets n=2^22: 20 rows "
          f"valid in {time.perf_counter() - t0:.1f} s", flush=True)
    opts = cli.RadixSortOptions(num_elements=1 << 25, iterations=2)
    ds = rt.datasets.RandomDistributed(np.uint32, seed=0)
    task = harness.SortTask(np.uint32, ds, options=opts,
                            config=rt.SortConfig(engine="merge"),
                            with_values=False, device=dev)
    res = harness.run_compute_task(task)
    require(res.valid, "key-only merge SortTask at 2^25 not valid")
    phases = harness.SortTask(np.uint32, ds, options=opts, device=dev)
    phases.init_resources()
    phases.measure_phases()
    prow = phases.perf_row(True, "radix")
    phases.release_resources()
    print(f"[harness] SortTask u32 key-only engine=merge n=2^25: valid, "
          f"{res.row.avg_total_gpu:.3f} ms; radix phases of a u32 KV sort "
          f"n=2^25: histogram {prow.avg_histogram:.3f} ms, scan "
          f"{prow.avg_scan:.3f} ms, reorder {prow.avg_reorder:.3f} ms",
          flush=True)
    csvio.write_rows([r.row for r in results] + [res.row], sys.stdout)
    sys.stdout.flush()


def beside_torch_sort(rt, fn):
    """time_ms of ``fn(config)`` with the default config (the radix
    kernels) and with the sorts on engine="torch_sort"."""
    return (time_ms(lambda: fn(rt.DEFAULT_CONFIG)),
            time_ms(lambda: fn(rt.SortConfig(engine="torch_sort"))))


def phase_query(dev, rt):
    """The SELECT of examples/query_pipeline.py with its shapes at 2^26
    orders and 2^22 customers (the example has 200k and 10k), then its top
    3 regions by revenue, against np.bincount.  At this size the int32
    revenue sums wrap, in the JAX package as here, so numpy's sums are
    taken modulo 2^32."""
    n_orders, n_cust = 1 << 26, 1 << 22
    rng = np.random.default_rng(0)
    cust = rng.integers(0, n_cust, n_orders).astype(np.uint32)
    amount = rng.integers(1, 500, n_orders).astype(np.int32)
    orders = rt.Table.from_numpy({"cust": cust, "amount": amount},
                                 device=dev)
    ids = np.arange(n_cust, dtype=np.uint32)
    customers = rt.Table.from_numpy({"cust": ids, "region": ids % 7},
                                    device=dev)

    def joined(config):
        return (rt.Query(orders, config).filter("amount", "ge", 50)
                .join(customers, on="cust"))

    def select(config=rt.DEFAULT_CONFIG):
        return (joined(config).group_by("region", orders=("count", None),
                                        revenue=("sum", "amount"))
                .sort_by("region").collect())

    def top(config=rt.DEFAULT_CONFIG):
        return (joined(config).group_by("region", revenue=("sum", "amount"))
                .top_k("revenue", 3).collect())

    keep = amount >= 50
    region = cust[keep] % 7
    exp_orders = np.bincount(region, minlength=7)
    exp_rev = np.bincount(region, weights=amount[keep], minlength=7).astype(
        np.int64).astype(np.int32)
    res = select().to_numpy()
    require(np.array_equal(res["region"], np.arange(7, dtype=np.uint32)),
            "query: regions differ")
    require(np.array_equal(res["orders"], exp_orders), "query: counts differ")
    require(np.array_equal(res["revenue"], exp_rev), "query: revenue differs")
    best = top().to_numpy()
    require(np.array_equal(best["revenue"], np.sort(exp_rev)[::-1][:3]),
            "query: top 3 regions differ")
    ms, ms_t = beside_torch_sort(rt, select)
    ms_k, ms_kt = beside_torch_sort(rt, top)
    print(f"[query] filter -> join -> group_by -> sort_by, 2^26 orders x "
          f"2^22 customers: validated vs np.bincount; {ms:.3f} ms "
          f"({n_orders / ms / 1e3:.1f} Mrows/s), with torch.sort inside "
          f"{ms_t:.3f} ms ({n_orders / ms_t / 1e3:.1f} Mrows/s); top 3 "
          f"regions {ms_k:.3f} ms, with torch.sort {ms_kt:.3f} ms",
          flush=True)


WINDOW_SPECS = {"rn": ("row_number",), "rk": ("rank",),
                "dr": ("dense_rank",), "cc": ("cum_count",),
                "s": ("cum_sum", "v"), "fs": ("cum_sum", "f"),
                "mn": ("cum_min", "v"), "mx": ("cum_max", "v"),
                "fv": ("first_value", "v"), "lg": ("lag", "v", 1),
                "ld": ("lead", "v", 3)}
WINDOW_PARTS = 1 << 16
PADDING = 4099
# float running sums: the doubling scan adds a partition's rows in another
# order than numpy's float64 reference
FS_RTOL = 1e-5


def window_columns(n: int, seed: int) -> dict:
    """Partition int32 in [0, 2^16), order int32 in [0, 2^20) with a third
    of the rows on 64 values (ties in every partition), v int32 in
    [-50, 50), f float32 in [0, 100)."""
    rng = np.random.default_rng(seed)
    order = rng.integers(0, 1 << 20, n).astype(np.int32)
    order[::3] >>= 14
    return {"p": rng.integers(0, WINDOW_PARTS, n).astype(np.int32),
            "o": order, "v": rng.integers(-50, 50, n).astype(np.int32),
            "f": (rng.random(n) * 100).astype(np.float32)}


def window_oracle(cols: dict, m: int) -> dict:
    """Every output of WINDOW_SPECS for every row, padding rows (index >=
    m) included, in numpy from the order np.lexsort((position, order,
    partition, invalid))."""
    n = cols["p"].size
    idx = np.arange(n)
    invalid = idx >= m
    srt = np.lexsort((idx, cols["o"], cols["p"], invalid))
    p, o, inv = cols["p"][srt], cols["o"][srt], invalid[srt]
    v = cols["v"][srt].astype(np.int64)
    part_new = np.ones(n, bool)
    part_new[1:] = (p[1:] != p[:-1]) | (inv[1:] != inv[:-1])
    order_new = part_new.copy()
    order_new[1:] |= o[1:] != o[:-1]
    start = np.maximum.accumulate(np.where(part_new, idx, 0))
    tie_start = np.maximum.accumulate(np.where(order_new, idx, 0))
    run = np.cumsum(part_new)
    rn = idx - start + 1

    def seg_sum(x):
        c = np.cumsum(x)
        return c - c[start] + x[start]

    def seg_max(x):  # x in [0, 256): partitions are 256 apart
        return np.maximum.accumulate(run * 256 + x) - run * 256

    nxt = np.minimum(idx + 3, n - 1)
    lead_ok = (idx + 3 < n) & (run[nxt] == run)
    out = {"rn": rn, "cc": rn, "rk": tie_start - start + 1,
           "dr": seg_sum(order_new.astype(np.int64)), "s": seg_sum(v),
           "fs": seg_sum(cols["f"][srt].astype(np.float64)),
           "mx": seg_max(v + 50) - 50, "mn": 49 - seg_max(49 - v),
           "fv": v[start], "lg": np.where(rn > 1, np.roll(v, 1), 0),
           "ld": np.where(lead_ok, v[nxt], 0)}
    back = {}
    for k, x in out.items():
        back[k] = np.empty_like(x)
        back[k][srt] = x
    return back


def check_window_on_card(rt, t, out, cols, m):
    """Checks of a window over m valid rows that need no per-row oracle:
    the row numbers place every row of a partition once, in (order,
    position) order; each partition's last cum_sum, cum_min and cum_max are
    its sum, min and max; first_value, lag and lead are the values of the
    first row and of the sorted neighbours."""
    dev = t.device
    P = WINDOW_PARTS
    p, o, v = t["p"][:m].long(), t["o"][:m], t["v"][:m]
    rn = out["rn"][:m].long()
    host_p = cols["p"][:m]
    cnt = torch.from_numpy(np.bincount(host_p, minlength=P)).to(dev)
    require(bool((cnt > 0).all()), "window: an empty partition")
    max_rn = torch.zeros(P, dtype=torch.int64, device=dev).scatter_reduce_(
        0, p, rn, "amax")
    require(torch.equal(max_rn, cnt), "window: max row_number != size")
    require(torch.equal(out["cc"], out["rn"]), "window: cum_count != rn")
    starts = torch.cumsum(cnt, 0) - cnt
    pos = starts[p] + rn - 1  # the row's place in the sorted order
    require(bool((torch.bincount(pos, minlength=m) == 1).all()),
            "window: row numbers do not number each partition once")
    row_at = torch.empty(m, dtype=torch.int64, device=dev)
    row_at[pos] = torch.arange(m, device=dev)
    ps, os_ = p[row_at], o[row_at]
    later = (ps[1:] > ps[:-1]) | ((ps[1:] == ps[:-1]) & (
        (os_[1:] > os_[:-1]) | ((os_[1:] == os_[:-1])
                                & (row_at[1:] > row_at[:-1]))))
    require(bool(later.all()), "window: row numbers do not follow "
                               "(partition, order, position)")
    last = rn == cnt[p]

    def at_last(name):
        """The column's value at each partition's last row, by partition."""
        c = out[name][:m]
        return torch.zeros(P, dtype=c.dtype, device=dev).index_copy_(
            0, p[last], c[last])

    require(np.array_equal(at_last("s").cpu().numpy(), np.bincount(
        host_p, weights=cols["v"][:m], minlength=P).astype(np.int32)),
        "window: last cum_sum != partition sum")
    fs = at_last("fs").cpu().numpy()
    require(np.allclose(fs, np.bincount(host_p, weights=cols["f"][:m].astype(
        np.float64), minlength=P), rtol=FS_RTOL),
        "window: last float cum_sum != partition sum")
    for name, red in (("mn", "amin"), ("mx", "amax")):
        want = torch.zeros(P, dtype=v.dtype, device=dev).scatter_reduce_(
            0, p, v, red, include_self=False)
        require(torch.equal(at_last(name), want),
                f"window: last {name} != partition {red}")
    vs = v[row_at]  # v in the sorted order
    require(torch.equal(out["fv"][:m], vs[starts][p]),
            "window: first_value != the partition's first value")
    require(torch.equal(out["lg"][:m], torch.where(
        rn > 1, vs[(pos - 1).clamp_min(0)], 0)), "window: lag differs")
    require(torch.equal(out["ld"][:m], torch.where(
        rn + 3 <= cnt[p], vs[(pos + 3).clamp_max(m - 1)], 0)),
        "window: lead differs")


def scan_share(rt, run):
    """Device time of one ``run()`` and of the segmented scans inside it,
    from torch.profiler's kernel rows: the scans' calls are recorded
    during one run and replayed alone."""
    from radix_sort_tpu_torch.ops import window as win

    calls = []
    real = {"_segmented_scan": win._segmented_scan,
            "run_starts": win.run_starts}

    def recorder(fn):
        def rec(*a, **kw):
            calls.append((fn, a, kw))
            return fn(*a, **kw)
        return rec

    for name, fn in real.items():
        setattr(win, name, recorder(fn))
    try:
        run()
    finally:
        for name, fn in real.items():
            setattr(win, name, fn)

    def replay():
        for fn, a, kw in calls:
            fn(*a, **kw)

    replay()
    total = _ms(_profile(run, 1), 1)
    scans = _ms(_profile(replay, 1), 1)
    return total, scans, len(calls)


def phase_window(dev, rt):
    """Query.window with every kind over 2^22 rows (every row, padding
    included, against window_oracle) and 2^26 rows (check_window_on_card),
    2^16 partitions, num_rows = capacity - 4099; timed beside
    engine="torch_sort", and the segmented scans' share of the device
    time."""
    for log2n in (22, 26):
        n = 1 << log2n
        m = n - PADDING
        cols = window_columns(n, seed=log2n)
        t = rt.Table.from_numpy(cols, num_rows=m, device=dev)

        def run(config=rt.DEFAULT_CONFIG):
            return rt.Query(t, config).window("p", "o",
                                              **WINDOW_SPECS).collect()

        out = run()
        require(int(out.num_rows) == m and out.capacity == n,
                "window: num_rows or capacity changed")
        if log2n == 22:
            want = window_oracle(cols, m)
            for name, w in want.items():
                got = rt.dtypes.tensor_to_numpy(out[name])
                ok = (np.allclose(got, w, rtol=FS_RTOL) if name == "fs"
                      else np.array_equal(got, w))
                require(ok, f"window 2^22: {name} differs from the oracle")
            how = "every row vs a numpy lexsort oracle"
        else:
            check_window_on_card(rt, t, out, cols, m)
            how = "partition sizes, sums, min/max, first/lag/lead on the card"
        del out
        ms, ms_t = beside_torch_sort(rt, run)
        total, scans, n_calls = scan_share(rt, run)
        print(f"[window] Query.window, 11 specs (every kind), 2^{log2n} rows, "
              f"2^16 partitions, {PADDING} padding rows: validated ({how}); "
              f"{ms:.3f} ms ({n / ms / 1e3:.1f} Mrows/s), with torch.sort "
              f"{ms_t:.3f} ms; device {total:.3f} ms, segmented scans "
              f"({n_calls} calls) {scans:.3f} ms, share {scans / total:.3f}",
              flush=True)
        del t


def phase_sort_by(dev, rt):
    """Query.sort_by on three keys (u32 ascending, int16 descending, f32
    ascending) over 2^26 rows with padding, against np.lexsort; an int64
    and a float64 column (NaN bits and -0.0 among its values) ride as
    8-byte planes and come back bit for bit."""
    n = 1 << 26
    m = n - PADDING
    rng = np.random.default_rng(12)
    f64 = rng.standard_normal(n)
    f64[::97] = -0.0
    f64.view(np.int64)[::101] = 0x7FF8_0000_DEAD_BEEF  # a NaN's payload
    cols = {"a": rng.integers(0, 1 << 10, n).astype(np.uint32),
            "b": rng.integers(-2**15, 2**15, n).astype(np.int16),
            "c": rng.standard_normal(n).astype(np.float32),
            "row": np.arange(n, dtype=np.int32),
            "w": rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64),
            "x": f64}
    t = rt.Table.from_numpy(cols, num_rows=m, device=dev)

    def run(config=rt.DEFAULT_CONFIG):
        return rt.Query(t, config).sort_by(
            "a", "b", "c", descending=[False, True, False]).collect()

    out = run().to_numpy()
    order = np.lexsort((cols["c"][:m], -cols["b"][:m].astype(np.int32),
                        cols["a"][:m]))
    require(np.array_equal(out["row"], order), "sort_by: order differs "
                                               "from np.lexsort")
    for k in ("a", "b", "c"):
        require(np.array_equal(out[k], cols[k][:m][order]),
                f"sort_by: column {k} differs")
    for k in ("w", "x"):  # bit for bit
        require(np.array_equal(out[k].view(np.int64),
                               cols[k][:m][order].view(np.int64)),
                f"sort_by: 8-byte column {k} differs")
    ms, ms_t = beside_torch_sort(rt, run)
    print(f"[sort_by] u32 asc, int16 desc, f32 asc over 2^26 rows, int64 "
          f"and float64 riding: validated vs np.lexsort; {ms:.3f} ms ({n / ms / 1e3:.1f} "
          f"Mrows/s), with torch.sort {ms_t:.3f} ms "
          f"({n / ms_t / 1e3:.1f} Mrows/s)", flush=True)


# float sums over ~67k rows a group, added in another order by each method
SEGMENT_RTOL = 1e-4


def phase_segment(dev, rt):
    """hash_aggregate(method="segment") against method="scan" on config
    3's data (2^26 rows, k < 500), with a float column: integer columns
    and means equal, float sums at SEGMENT_RTOL."""
    from radix_sort_tpu_torch.ops import aggregate, filter as filt

    n = 1 << 26
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 1000, n).astype(np.uint32)
    vals = rng.integers(0, 100, n).astype(np.int32)
    f = (rng.random(n) * 100).astype(np.float32)
    t = rt.Table.from_numpy({"k": keys, "x": vals, "f": f}, device=dev)
    aggs = {"n": ("count", None), "s": ("sum", "x"), "lo": ("min", "x"),
            "hi": ("max", "x"), "m": ("mean", "x"), "fs": ("sum", "f")}

    def run(method, config=rt.DEFAULT_CONFIG):
        return aggregate.hash_aggregate(
            filt.filter_expr(t, "k", "lt", 500, config=config), "k", aggs,
            config=config, method=method)

    seg, scan = run("segment").to_numpy(), run("scan").to_numpy()
    mask = keys < 500
    require(np.array_equal(seg["n"], np.bincount(keys[mask], minlength=500)),
            "segment: counts differ from np.bincount")
    for k, want in scan.items():
        got = seg[k]
        require(got.dtype == want.dtype, f"segment: {k} dtype {got.dtype} "
                                         f"!= {want.dtype}")
        ok = (np.allclose(got, want, rtol=SEGMENT_RTOL) if k == "fs"
              else np.array_equal(got, want))
        require(ok, f"segment: {k} differs from method='scan'")
    ms, ms_t = beside_torch_sort(rt, lambda c: run("segment", c))
    ms_scan = time_ms(lambda: run("scan"))
    print(f"[segment] filter(k<500) -> hash_aggregate(method='segment') of "
          f"count/sum/min/max/mean + f32 sum, 2^26 rows: equal to "
          f"method='scan' (f32 sums rtol {SEGMENT_RTOL}); {ms:.3f} ms "
          f"({n / ms / 1e3:.1f} Mrows/s), with torch.sort {ms_t:.3f} ms; "
          f"method='scan' {ms_scan:.3f} ms", flush=True)


def phase_io(dev, rt):
    """save_table / load_table of 2^24 rows (uint32, int64, float32, 1000
    padding rows) bit for bit, and a BatchWriter of 4 batches read back by
    iter_batches, in a temporary directory."""
    n = 1 << 24
    rng = np.random.default_rng(13)
    cols = {"u": rng.integers(0, 2**32, n, dtype=np.uint64).astype(
                np.uint32),
            "i": rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64),
            "f": rng.standard_normal(n).astype(np.float32)}
    t = rt.Table.from_numpy(cols, num_rows=n - 1000, device=dev)
    c = rt.dtypes.as_container

    def same(a, b):
        return (a.capacity == b.capacity
                and int(a.num_rows) == int(b.num_rows)
                and all(a[k].dtype == b[k].dtype and a[k].device == b[k].device
                        and torch.equal(c(a[k]), c(b[k])) for k in cols))

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        path = rt.io.save_table(t, os.path.join(d, "t"))
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = rt.io.load_table(path, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        require(same(back, t), "io: the loaded table differs")
        q = n // 4
        parts = [rt.Table({k: v[i * q:(i + 1) * q] for k, v in t.columns.items()},
                          num_rows=q - i) for i in range(4)]
        w = rt.io.BatchWriter(os.path.join(d, "runs"))
        for part in parts:
            w.write(part)
        w.finish()
        loaded = list(rt.io.iter_batches(os.path.join(d, "runs"),
                                         device=dev))
        require(len(loaded) == 4 and all(map(same, loaded, parts)),
                "io: the batches read back differ")
        mb = os.path.getsize(path) / 1e6
    print(f"[io] save_table / load_table 2^24 rows (u32, i64, f32, padding): "
          f"bit for bit; {mb:.1f} MB saved in {save_s:.3f} s, loaded onto "
          f"the card in {load_s:.3f} s; BatchWriter 4 batches read back "
          f"equal", flush=True)


def phase_datasets_device(dev, rt):
    """Every distribution as u32, i64 and f32 at 2^25 made on the card:
    the contract (dtype, shape, Zeros, Range / InvertedRange equal to the
    host's, extremes planted, floats in [-1e9, 1e9]), then a sort of it
    validated by check_sorted_kv; its time beside the host generator plus
    the upload."""
    n = 1 << 25
    dd = rt.datasets_device
    for dtype in (np.uint32, np.int64, np.float32):
        d = np.dtype(dtype)
        hosts = {ds.name: ds for ds in rt.datasets.make_datasets(d, seed=0)}
        for name in dd.ALL_NAMES:
            what = f"datasets_device {name} {d.name} 2^25"
            keys = dd.generate(name, d, n, seed=1, device=dev)
            require(keys.dtype == rt.dtypes.torch_dtype(d)
                    and keys.shape == (n,) and keys.device == dev,
                    f"{what}: dtype, shape or device")
            host = rt.dtypes.tensor_to_numpy(keys)
            if name == "Zeros":
                require(not host.any(), f"{what}: not all zero")
            elif name in ("Range", "InvertedRange"):
                require(np.array_equal(host, hosts[name].generate(n)),
                        f"{what}: differs from the host dataset")
            else:
                inner = host[1:-1]
                if d.kind == "f":
                    require(np.isfinite(inner).all()
                            and np.abs(inner).max() <= 1e9,
                            f"{what}: floats outside [-1e9, 1e9]")
                if name == "RandomDistributed":
                    lo, hi = ((-np.inf, np.inf) if d.kind == "f"
                              else (np.iinfo(d).min, np.iinfo(d).max))
                    require(host[0] == lo and host[-1] == hi,
                            f"{what}: extremes not planted")
            check_sorted_kv(rt, keys, rt.sort(keys), None, host, what)
            gen_ms = time_ms(lambda: dd.generate(name, d, n, seed=1,
                                                 device=dev))
            t0 = time.perf_counter()
            rt.dtypes.tensor_from_numpy(hosts[name].generate(n), dev)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
            print(f"[datasets_device] {name} {d.name} 2^25: contract and "
                  f"sort validated; made on the card {gen_ms:.3f} ms, host "
                  f"generator + upload {host_ms:.1f} ms", flush=True)
            del keys, host


def phase_examples(dev, rt):
    """The three port examples as subprocesses on the card."""
    root = os.path.dirname(os.path.abspath(__file__))

    def run(*args):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, *args, "--device", "cuda"],
                           cwd=root, capture_output=True, text=True,
                           timeout=600)
        require(r.returncode == 0, f"{args[0]} exited {r.returncode}: "
                                   f"{r.stderr[-2000:]}")
        return r.stdout, time.perf_counter() - t0

    out, s = run("examples/torch_basic_sort.py", "--num-elements",
                 str(1 << 26))
    require("validation: OK" in out, f"torch_basic_sort: {out[-500:]}")
    lines = out.strip().splitlines()
    print(f"[examples] torch_basic_sort.py --num-elements 67108864: "
          f"{lines[0]} | {lines[-2]} | {lines[-1]} ({s:.1f} s)", flush=True)
    out, s = run("examples/torch_query_pipeline.py")
    require("validation: OK" in out, f"torch_query_pipeline: {out[-500:]}")
    print(f"[examples] torch_query_pipeline.py: validation: OK ({s:.1f} s)",
          flush=True)
    with tempfile.TemporaryDirectory() as d:
        png = os.path.join(d, "viz.png")
        out, s = run("examples/torch_visualize.py", png)
        require(os.path.exists(png) and os.path.getsize(png) > 10000,
                f"torch_visualize: no PNG ({out[-500:]})")
        print(f"[examples] torch_visualize.py: {out.strip()} "
              f"({os.path.getsize(png)} bytes, {s:.1f} s)", flush=True)


# ------------------------------------------------------------ the dist path
#
# The rank functions run in processes that mesh.run_ranks spawns; they
# import this file as a module (its main() runs only under __main__) and
# send back their lines, launch counts, host reads and times.

DIST1_N = 1 << 27       # dist_sort_kv at one NCCL rank
CONFIG5_N = 1 << 26     # config 5's probe rows at one NCCL rank
DIST4_PER_RANK = 1 << 22  # four gloo ranks sharing the card
DIST_REPS = 3


def _reads():
    from radix_sort_tpu_torch.ops import stream
    from radix_sort_tpu_torch.parallel import exchange

    return exchange.host_reads, stream.host_reads


def _config5(mesh, pk: np.ndarray, rows_label: str, lines: list):
    """BASELINE config 5 on this mesh, as
    scripts/torch_baseline_configs.py runs and checks it (``config5_query``:
    join, count aggregate and KV sort of the probe ``pk``, which every rank
    holds); its checks required and its line added to ``lines``.  Returns
    the three operators' ms as one query."""
    r = script("torch_baseline_configs").config5_query(mesh, pk)
    for k in ("join_valid", "agg_valid", "sort_valid"):
        require(r[k], f"config5 {rows_label}: {k} is false")
    ms, three = r["ms"], r["three_ms"]
    lines.append(
        f"config 5 {rows_label}: validated (join {r['matches']} matches, bv "
        f"= 7k, the joined keys' counts; aggregate vs np.unique counts; sort "
        f"the stable sort of the gathered rows); join {ms['join']:.3f} ms, "
        f"aggregate {ms['aggregate']:.3f} ms, sort {ms['sort']:.3f} ms, the "
        f"three {three:.3f} ms ({pk.size / three / 1e3:.1f} Mrows/s), with "
        f"torch.sort inside {r['torch_sort_three_ms']:.3f} ms; host reads of "
        f"the join: {r['join_host_reads'][0]} exchange, "
        f"{r['join_host_reads'][1]} sort")
    return three


def dist1_rank(mesh, pk_path: str):
    """[dist1]: one NCCL rank on the card.  dist_sort_kv of u32 keys with
    an iota payload at 2^27 (RandomDistributed, Zeros) beside sort_kv of
    the same data, bit for bit; config 5 at 2^26 probe rows; the health
    check."""
    import radix_sort_tpu_torch as rt
    from radix_sort_tpu_torch.parallel import dist_sort, runtime

    lines = []
    reset_launch_counts()
    dev = mesh.device
    n = DIST1_N
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    res = {}
    for ds in (rt.datasets.RandomDistributed(np.uint32, seed=0),
               rt.datasets.Zeros(np.uint32)):
        host = ds.generate(n)
        keys = rt.dtypes.tensor_from_numpy(host, dev)
        what = f"dist_sort_kv u32 {ds.name} 2^{n.bit_length() - 1}"
        r0 = _reads()
        ks, vs, ovf = dist_sort.dist_sort_kv(keys, iota, mesh=mesh)
        torch.cuda.synchronize()
        r1 = _reads()
        require(not ovf, f"{what}: overflow")
        check_sorted_kv(rt, keys, ks, vs, host, what)
        ko, po = rt.sort_kv(keys, iota)
        require(torch.equal(ks.view(torch.int32), ko.view(torch.int32))
                and torch.equal(vs, po), f"{what}: differs from sort_kv")
        ms = time_ms(lambda: dist_sort.dist_sort_kv(keys, iota, mesh=mesh),
                     DIST_REPS)
        ms_s = time_ms(lambda: rt.sort_kv(keys, iota), DIST_REPS)
        res[ds.name] = (ms, ms_s)
        lines.append(
            f"{what}: validated (check_sorted_kv, and bit for bit sort_kv's"
            f"); {ms:.3f} ms ({n / ms / 1e3:.1f} Mpairs/s), sort_kv "
            f"{ms_s:.3f} ms: the dist layer adds {ms - ms_s:.3f} ms; host "
            f"reads {r1[0] - r0[0]} exchange + {r1[1] - r0[1]} sort")
        del keys, ks, vs, ko, po
    del iota
    pk = np.load(pk_path)
    res["config5"] = _config5(
        mesh, pk[:CONFIG5_N], f"2^{CONFIG5_N.bit_length() - 1} rows, 1 "
        f"{mesh.backend} rank", lines)
    status = runtime.health_check(mesh)
    require(status["ok"] and status["heartbeat_total"] == 1,
            f"health_check {status}")
    lines.append(f"health_check: {status}")
    torch.cuda.synchronize()
    return {"lines": lines, "launches": launch_counts(), "times": res}


def dist4_rank(mesh, pk_path: str):
    """[dist4]: four gloo ranks whose tensors all live on cuda:0, 2^22
    rows a rank.  dist_sort_kv over the five distributions, full-range
    u64 and config 5's Zipf keys at G = 1 and 2, each gathered and held
    against np.argsort(kind="stable") (case i on rank i % 4); config 5;
    dist_top_k with ties against numpy's stable order."""
    import radix_sort_tpu_torch as rt
    from radix_sort_tpu_torch.parallel import dist_ops, dist_sort
    from radix_sort_tpu_torch.parallel import mesh as mesh_lib, runtime
    from radix_sort_tpu_torch.utils import profiling

    lines = []
    reset_launch_counts()
    dev = mesh.device
    N = mesh.size * DIST4_PER_RANK
    rng = np.random.default_rng(9)
    cases = [(ds.name, ds.generate(N))
             for ds in rt.datasets.make_datasets(np.uint32, 0)]
    cases.append(("u64 full range", rng.integers(0, 2**64, N,
                                                 dtype=np.uint64)))
    pk = np.load(pk_path)[:N]
    cases.append(("config 5 zipf", pk))
    vals = mesh_lib.shard_1d(np.arange(N, dtype=np.int32), mesh)
    times = {}
    for i, (name, host) in enumerate(cases):
        keys = mesh_lib.shard_1d(host, mesh)
        perm = (np.argsort(host, kind="stable") if i % mesh.size == mesh.rank
                else None)
        for G in (1, 2):
            r0 = _reads()
            ks, vs, ovf = dist_sort.dist_sort_kv(keys, vals, mesh=mesh,
                                                 overlap_chunks=G)
            r1 = _reads()
            require(not ovf, f"dist4 {name} G={G}: overflow")
            allr = dist_ops.gather_rows({"k": ks, "v": vs}, ks.shape[0],
                                        mesh)
            if perm is not None:
                require(np.array_equal(allr["v"], perm)
                        and np.array_equal(allr["k"], host[perm]),
                        f"dist4 {name} G={G}: differs from np.argsort")
            ms = profiling.rank_ms(lambda: dist_sort.dist_sort_kv(
                keys, vals, mesh=mesh, overlap_chunks=G), mesh, DIST_REPS)
            times[(name, G)] = ms
            lines.append(
                f"dist_sort_kv {host.dtype.name} {name} 2^"
                f"{N.bit_length() - 1} ({N // mesh.size} a rank) "
                f"G={G}: validated vs np.argsort(kind='stable') on rank "
                f"{i % mesh.size}; {ms:.3f} ms (slowest rank), "
                f"{N / ms / 1e3:.1f} Mpairs/s; host reads a rank "
                f"{r1[0] - r0[0]} exchange + {r1[1] - r0[1]} sort")
    rows = f"2^{N.bit_length() - 1}"
    times["config5"] = _config5(
        mesh, pk, f"{rows} rows, {mesh.size} {mesh.backend} ranks on one "
        f"card", lines)
    ties = np.random.default_rng(29).integers(0, 8, N).astype(np.uint32)
    t = dist_ops.shard_table(rt.Table.from_numpy(
        {"k": ties, "row": np.arange(N, dtype=np.int32)}, device=dev), mesh)
    want = np.argsort(-ties.astype(np.int64), kind="stable")[:1024]
    top = dist_ops.dist_top_k(t, "k", 1024, mesh=mesh).to_numpy()
    require(np.array_equal(top["row"], want)
            and np.array_equal(top["k"], ties[want]),
            "dist_top_k with ties differs from numpy's stable order")
    ms = profiling.rank_ms(lambda: dist_ops.dist_top_k(t, "k", 1024,
                                                       mesh=mesh), mesh,
                           DIST_REPS)
    lines.append(f"dist_top_k k=1024 of 2^{N.bit_length() - 1} keys in "
                 f"[0, 8): validated vs "
                 f"numpy's stable order; {ms:.3f} ms")
    status = runtime.health_check(mesh)
    require(status["ok"] and status["heartbeat_total"] == mesh.size,
            f"health_check {status}")
    lines.append(f"health_check: {status}")
    torch.cuda.synchronize()
    return {"lines": lines, "launches": launch_counts(), "times": times}


def phase_dist(dev, rt):
    """[dist1] and [dist4] in rank processes (mesh.run_ranks); their lines
    printed here, their launches added to this process's counters, and
    every rank required to have launched pass_histograms and
    onesweep_pass."""
    from radix_sort_tpu_torch.parallel import mesh as mesh_lib

    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the ranks allocate on the same card
    with tempfile.TemporaryDirectory() as d:
        pk_path = os.path.join(d, "config5_probe.npy")
        t0 = time.perf_counter()
        np.save(pk_path, script("torch_baseline_configs").config5_probe(
            CONFIG5_N))
        print(f"[dist] config 5 probe keys, zipf(1.3) % 4096 at "
              f"2^{CONFIG5_N.bit_length() - 1}, made in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        out = {}
        for tag, fn, ranks, backend, device in (
                ("dist1", dist1_rank, 1, "nccl", "cuda"),
                ("dist4", dist4_rank, 4, "gloo", "cuda:0")):
            t0 = time.perf_counter()
            res = mesh_lib.run_ranks(fn, ranks, backend=backend,
                                     device=device, args=(pk_path,),
                                     timeout_s=600)
            for r, rr in enumerate(res):
                for k in ("pass_histograms", "onesweep_pass"):
                    require(rr["launches"][k] > 0,
                            f"{tag} rank {r}: {k} never launched")
                for k, v in rr["launches"].items():
                    CHILD_LAUNCHES[k] = CHILD_LAUNCHES.get(k, 0) + v
            for line in res[0]["lines"]:
                print(f"[{tag}] {line}", flush=True)
            print(f"[{tag}] {ranks} {backend} rank(s) on {device}: "
                  f"{time.perf_counter() - t0:.1f} s from spawn to exit; "
                  f"launches by rank "
                  f"{[rr['launches'] for rr in res]}", flush=True)
            out[tag] = res[0]["times"]
    return out


def phase_chunked(dev, rt):
    """sort_kv(engine="chunked") of u32 and u64 KV at 2^27 on
    RandomDistributed and Zeros, bit for bit the radix and torch.sort
    results of the same data (torch.sort(stable=True) is the oracle on the
    card), each timed beside both."""
    from radix_sort_tpu_torch.ops import stream

    n = 1 << 27
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    c = rt.dtypes.as_container
    for dtype in (np.uint32, np.uint64):
        for ds in (rt.datasets.RandomDistributed(dtype, seed=0),
                   rt.datasets.Zeros(dtype)):
            keys = rt.dtypes.tensor_from_numpy(ds.generate(n), dev)
            what = (f"sort_kv {np.dtype(dtype).name} {ds.name} "
                    f"2^{n.bit_length() - 1}")
            before, reads = launch_counts(), stream.host_reads
            ko, po = rt.sort_kv(keys, iota, engine="chunked")
            torch.cuda.synchronize()
            delta = {k: v - before[k] for k, v in launch_counts().items()
                     if v - before[k]}
            reads = stream.host_reads - reads
            for engine in ("radix", "torch_sort"):
                k2, p2 = rt.sort_kv(keys, iota, engine=engine)
                require(torch.equal(c(ko), c(k2)) and torch.equal(po, p2),
                        f"{what}: chunked differs from {engine}")
            del k2, p2
            ms = {e: time_ms(lambda: rt.sort_kv(keys, iota, engine=e))
                  for e in ("chunked", "radix", "torch_sort")}
            print(f"[chunked] {what} engine=chunked: bit for bit radix's "
                  f"and torch.sort's; chunked {ms['chunked']:.3f} ms "
                  f"({n / ms['chunked'] / 1e3:.1f} Mpairs/s), radix "
                  f"{ms['radix']:.3f} ms, torch.sort {ms['torch_sort']:.3f} "
                  f"ms; launches {delta}, host reads {reads}", flush=True)
            del keys, ko, po


# ----------------------------------------------------------- the bench path
#
# The port's measurement entry points run on the card through their own
# functions, every result validated by the programs' own checks.

SCALING_ROWS = 1 << 22  # rows a rank of the scaling bench


def phase_headline(dev, rt):
    """bench_torch.py at 2^25 under radix (engine auto) and merge: each
    JSON line printed after ``[headline]`` (its validation raises)."""
    bench = script("bench_torch")
    out = {}
    for engine in ("auto", "merge"):
        rec = bench.run(25, engine, str(dev))
        print(f"[headline] {json.dumps(rec)}", flush=True)
        out[engine] = rec
    return out


def phase_sweep(dev, rt):
    """scripts/torch_benchmark.py over n = 2^25, 2^20, 2^15, 2^10, u32 and
    u64, the five distributions, with the phase columns and the CPU
    baselines below 2^25; every row valid, the CSVs in chiprun_out/."""
    sweep = script("torch_benchmark")
    common = ["--datatypes", "u32,u64", "--device", str(dev), "--perf-to-csv"]
    rows = []
    for argv in (["--min-log2", "25", "--max-log2", "25",
                  "--no-cpu-baselines"],
                 ["--min-log2", "10", "--max-log2", "20", "--step", "5"]):
        rows += sweep.sweep(sweep.build_parser().parse_args(argv + common))
    require(len(rows) == 40 and all(r.valid for r in rows),
            f"sweep: {len(rows)} rows, valid {[r.valid for r in rows]}")


def phase_configs12(dev, rt):
    """scripts/torch_baseline_configs.py configs 1 and 2 (u32 and u64 KV
    at 2^27 over Zeros, Random, Range and InvertedRange), written to
    chiprun_out/baseline_results_torch.json; every record valid."""
    tbc = script("torch_baseline_configs")
    recs = tbc.run_configs(tbc.build_parser().parse_args(
        ["1", "2", "--cfg2-log2n", "27", "--device", str(dev)]))
    bad = [k for k, r in recs.items() if not r["valid"]]
    require(len(recs) == 9 and not bad,
            f"configs 1-2: {len(recs)} records, not valid: {bad}")


def phase_scaling(dev, rt):
    """scripts/torch_scaling_bench.py with --check-ops at 2^22 rows a
    rank: one NCCL rank, then 2 and 4 gloo ranks sharing the card; every
    record valid, every rank's launches added to this process's."""
    bench = script("torch_scaling_bench")
    for sizes, backend in (([1], "nccl"), ([2, 4], "gloo")):
        recs, launches = bench.scaling(sizes, SCALING_ROWS, True, backend,
                                       str(dev))
        for r in recs:
            require(r["valid"] and r["agg_valid"] and r["join_valid"],
                    f"scaling {r}: not valid")
            print(f"[scaling] {json.dumps(r)}", flush=True)
        for rank, counts in enumerate(launches):
            for k in ("pass_histograms", "onesweep_pass"):
                require(counts[k] > 0, f"scaling {backend} rank {rank}: {k} "
                                       f"never launched")
            for k, v in counts.items():
                CHILD_LAUNCHES[k] = CHILD_LAUNCHES.get(k, 0) + v


def run_path(name, phases, kernels):
    """Drive one path with every launch counter at 0 before it; require
    each of ``kernels`` to have launched in it.  Returns the counts."""
    reset_launch_counts()
    for phase in phases:
        phase()
    torch.cuda.synchronize()
    counts = launch_counts()
    for k in kernels:
        require(counts[k] > 0, f"{k} never launched on the {name} path")
    print(f"[summary] {name} path launches {counts}", flush=True)
    return counts


def main() -> int:
    card = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    import radix_sort_tpu_torch as rt
    from radix_sort_tpu_torch.ops import cuda_merge as cm, cuda_radix as cr

    kernel_res = phase_kernels(dev, rt, cr, cm)

    torch.cuda.reset_peak_memory_stats()
    radix_kernels = ("pass_histograms", "onesweep_pass")
    # [dtypes] sorts 8- and 16-bit keys on the narrow pass
    radix = run_path("radix", (lambda: phase_sort(dev, rt),
                               lambda: phase_profile(dev, rt),
                               lambda: phase_nosync(dev, rt),
                               lambda: phase_config3(dev, rt),
                               lambda: phase_config4(dev, rt),
                               lambda: phase_dtypes(dev, rt)),
                     radix_kernels + NARROW_KERNELS)
    # the harness's per-phase timings run the three-launch pass
    merge = run_path("merge", (lambda: phase_merge(dev, rt),
                               lambda: phase_merge_profile(dev, rt),
                               lambda: phase_topk(dev, rt),
                               lambda: phase_harness(dev, rt)),
                     radix_kernels + ("digit_histogram", "exclusive_scan",
                                      "rank_scatter", "tile_sort",
                                      "merge_level"))
    query = run_path("query", (lambda: phase_query(dev, rt),
                               lambda: phase_window(dev, rt),
                               lambda: phase_sort_by(dev, rt),
                               lambda: phase_segment(dev, rt),
                               lambda: phase_io(dev, rt),
                               lambda: phase_datasets_device(dev, rt),
                               lambda: phase_examples(dev, rt)),
                     radix_kernels + WIDE_KERNELS)
    # the ranks' launches are in the counts (CHILD_LAUNCHES); phase_dist
    # requires both kernels on every rank
    dist = run_path("dist", (lambda: phase_dist(dev, rt),
                             lambda: phase_chunked(dev, rt)), radix_kernels)
    # the entry points: the headline under auto launches the radix pair,
    # under merge tile_sort and merge_level; the sweep's phase columns the
    # three-launch pass
    bench = run_path("bench", (lambda: phase_headline(dev, rt),
                               lambda: phase_sweep(dev, rt),
                               lambda: phase_configs12(dev, rt),
                               lambda: phase_scaling(dev, rt)),
                     tuple(k for k in REPLACES
                           if k not in NARROW_KERNELS + WIDE_KERNELS))
    launches = {k: radix[k] + merge[k] + query[k] + dist[k] + bench[k]
                for k in REPLACES}
    peak = torch.cuda.max_memory_allocated()
    print(f"[summary] launches on the five paths {launches}; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB; card {card}",
          flush=True)

    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "call_ms": r["call_ms"], "plain_call_ms": r["plain_call_ms"]}
               for name, r in kernel_res.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
