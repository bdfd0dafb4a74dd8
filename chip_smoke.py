"""Drive the PyTorch/CUDA port's main path once on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels of ``radix_sort_tpu_torch`` from ``csrc/`` (into
``build/kernels/``, one ``nvcc`` a source, started together) and the native
host baselines of ``native/`` where a C++ compiler is present, holds each
kernel bit-exact against its plain torch version at the shapes the main
path gives it (the onesweep pass in look-back mode at u32 KV 2^27 on
RandomDistributed and Zeros, u64 KV 2^27, a ragged n, 17 planes and the
partition's pass; ``pass_histograms`` at 2^27 for 32- and 64-bit keys;
``rank_scatter`` in base-table mode at 2^22), then runs two paths at
BASELINE sizes through the public entry points, each with the kernels'
launch counters set to 0 just before it and read just after:

  the radix path
  - ``sort_kv``: u32 keys + int32 iota payload at 2^27 over the five
    ``datasets`` distributions, u64 keys at 2^27, and ``sort`` u32 key-only
    at 2^25, each timed beside ``engine="torch_sort"`` (torch.sort);
  - ``[profile]``: a u32 KV 2^27 sort's launches (1 ``pass_histograms``,
    4 ``onesweep_pass``), host reads (1) and device time by kernel, and the
    idle share of back-to-back u32 key-only sorts at 2^25;
  - config 3: ``filter_expr(k < 500)`` → ``hash_aggregate(count, sum)`` over
    2^26 rows, checked against ``np.bincount``;
  - config 4: ``hash_join`` of a 2^20-row probe against a 2^18-row unique
    build, checked against numpy;

  the merge path
  - ``sort(engine="merge")``: u32 key-only at 2^25 over the five
    distributions, i32 and f32 at 2^25, u32 at 2^25 - 777 and at 2^27, each
    timed beside ``radix`` and ``torch_sort``;
  - ``top_k`` at 2^25 with k = 2^24 under ``engine="merge"`` and k = 1024,
    and ``top_k_kv`` with heavy ties, against numpy;
  - the harness: ``run_all`` over u32/i32/u64/i64 x five distributions at
    2^22, and a key-only ``SortTask`` under ``engine="merge"`` at 2^25,
    every row valid; the CSV rows are printed.

Every phase raises on a failure, so the exit code is non-zero and the last
line is not printed.  The last line is the JSON object
``{"ok": true, "device": {...}}``; the line before it lists each kernel with
its launch count on the two paths, its device time beside the plain
version's (``ms``, ``plain_ms``: CUDA events around 50 back-to-back calls,
divided by 50), its bound (``bound_ms``: the bytes it must move at 3.35
TB/s), the time of one PyTorch call that computes the same function where
there is one (``library_ms``), and the time of one call with its host work
(``call_ms``, ``plain_call_ms``: CUDA events around a single call).
Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

RADIX_CU = "radix_sort_tpu_torch/csrc/radix.cu"
MERGE_CU = "radix_sort_tpu_torch/csrc/merge.cu"
SOURCES = {"digit_histogram": RADIX_CU, "exclusive_scan": RADIX_CU,
           "rank_scatter": RADIX_CU, "pass_histograms": RADIX_CU,
           "onesweep_pass": RADIX_CU, "tile_sort": MERGE_CU,
           "merge_level": MERGE_CU}
K3_K4 = ("radix_sort_tpu/ops/pallas_radix.py:263; "
         "radix_sort_tpu/ops/pallas_stream.py:427")
REPLACES = {
    "digit_histogram": "radix_sort_tpu/ops/pallas_radix.py:140",
    "exclusive_scan": "radix_sort_tpu/ops/pallas_radix.py:217",
    "rank_scatter": K3_K4,  # base-table mode
    "pass_histograms": "radix_sort_tpu/ops/pallas_radix.py:140",
    "onesweep_pass": K3_K4,  # look-back mode of the same kernel
    "tile_sort": "radix_sort_tpu/ops/pallas_merge.py:265",
    "merge_level": "radix_sort_tpu/ops/pallas_merge.py:283",
}
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


def timings(fn, plain) -> dict:
    """A kernel's and its plain version's device and single-call times."""
    return {"ms": device_ms(fn), "plain_ms": device_ms(plain),
            "call_ms": time_ms(fn), "plain_call_ms": time_ms(plain)}


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


def launch_counts():
    from radix_sort_tpu_torch.ops import cuda_merge, cuda_radix

    return {**cuda_radix.launch_counts(), **cuda_merge.launch_counts()}


def reset_launch_counts():
    from radix_sort_tpu_torch.ops import cuda_merge, cuda_radix

    cuda_radix.reset_launch_counts()
    cuda_merge.reset_launch_counts()


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
    # launch each (R = 256), and R = 2 / 16 over one plane
    hi = torch.from_numpy(rng.integers(0, 1 << 20, n).astype(np.int32)).to(dev)
    cases = [("u32 2^27 (4 passes)", (x,), (4,), 256),
             ("u64 2^27 (lo + hi, 8 passes)", (x, hi), (4, 4), 256),
             ("u32 2^27 R=16 (8 passes)", (x,), (8,), 16),
             ("u32 2^26 R=2 (32 passes)", (x[:1 << 26],), (32,), 2)]
    for what, planes, passes, radix in cases:
        err = max_abs_err(cr.pass_histograms(planes, passes, radix),
                          cr.pass_histograms_plain(planes, passes, radix))
        require(err == 0, f"pass_histograms {what} disagrees")
        print(f"[kernels] pass_histograms {what}: bit-exact", flush=True)
    t = timings(lambda: cr.pass_histograms((x,), (4,), 256),
                lambda: cr.pass_histograms_plain((x,), (4,), 256))
    note("pass_histograms", 0, t, nbytes=4 * n + 4 * 4 * 256)
    t64 = device_ms(lambda: cr.pass_histograms((x, hi), (4, 4), 256))
    print(f"[kernels] pass_histograms u32 2^27: device {t['ms']:.5f} ms "
          f"(bound {res['pass_histograms']['bound_ms']:.5f} ms), plain "
          f"{t['plain_ms']:.5f} ms; u64 2^27: {t64:.5f} ms", flush=True)
    del x, hi

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

    # K5 and K6 at the shapes of a 2^25 key-only sort: 2048 tiles, levels
    # 0 and 10 (the last), on keys in the kernels' sign-flipped domain.
    n = 1 << 25
    last = (n // cm.TILE).bit_length() - 2
    for ds in (rt.datasets.RandomDistributed(np.uint32, seed=0),
               rt.datasets.Zeros(np.uint32)):
        keys = rt.dtypes.tensor_from_numpy(ds.generate(n), dev)
        x = rt.dtypes.signed_order(rt.dtypes.to_sortable(keys))
        tiles = cm.tile_sort(x)
        err = max_abs_err(tiles, cm.tile_sort_plain(x))
        require(err == 0, f"tile_sort on {ds.name} disagrees")
        print(f"[kernels] tile_sort n={n} {ds.name}: bit-exact", flush=True)
        level_in, cur = {}, tiles
        for level in range(last + 1):
            level_in[level] = cur
            cur, _ = cm.merge_level(cur, level)
        require(bool((cur[1:] >= cur[:-1]).all()),
                f"merge levels on {ds.name}: not sorted")
        for level in (0, last):
            xin = level_in[level]
            got, splits = cm.merge_level(xin, level, with_splits=True)
            want_splits = cm.level_splits_plain(xin, level)
            err = max(max_abs_err(a, b) for a, b in zip(splits, want_splits))
            require(err == 0, f"merge_level {level} splits on {ds.name} "
                              f"disagree")
            err = max_abs_err(got, cm.merge_level_plain(xin, *want_splits))
            require(err == 0, f"merge_level {level} on {ds.name} disagrees")
            print(f"[kernels] merge_level n={n} level {level} {ds.name} "
                  f"(splits + output): bit-exact", flush=True)
        if ds.name == "RandomDistributed":
            note("tile_sort", 0, timings(lambda: cm.tile_sort(x),
                                         lambda: cm.tile_sort_plain(x)),
                 nbytes=8 * n,
                 library=lambda: torch.sort(x.view(-1, cm.TILE), dim=-1,
                                            stable=True))
            xin = level_in[0]
            ms0 = device_ms(lambda: cm.merge_level(xin, 0))
            xin = level_in[last]
            note("merge_level", 0,
                 timings(lambda: cm.merge_level(xin, last),
                         lambda: cm.merge_level_plain(
                             xin, *cm.level_splits_plain(xin, last))),
                 nbytes=8 * n + 12 * (n // cm.TILE))
            print(f"[kernels] merge_level n={n}: level 0 {ms0:.3f} ms, level "
                  f"{last} {res['merge_level']['ms']:.3f} ms (plain "
                  f"{res['merge_level']['plain_ms']:.3f} ms); tile_sort "
                  f"{res['tile_sort']['ms']:.3f} ms (plain "
                  f"{res['tile_sort']['plain_ms']:.3f} ms, torch.sort of "
                  f"the tiles {res['tile_sort']['library_ms']:.3f} ms)",
                  flush=True)
        del keys, x, tiles, level_in, cur
    after = launch_counts()
    for name in REPLACES:
        require(after[name] > before[name], f"{name} launch counter idle")
    torch.cuda.synchronize()
    return res


def phase_onesweep(dev, rt, cr, note, res):
    """The pass kernel in look-back mode against its plain version: a u32
    KV pass at 2^27 (RandomDistributed and Zeros), a u64 KV pass, a ragged
    n, 17 planes, and the partition's pass (digit plane not moved)."""
    n = 1 << 27
    tile = rt.DEFAULT_CONFIG.tile_elems  # the sort's tile
    iota = torch.arange(n, dtype=torch.int32, device=dev)

    def check(what, digit, planes, radix=256, shift=0):
        counts = torch.bincount(cr._digits(digit, radix, shift).long(),
                                minlength=radix).int()
        outs, _ = cr.onesweep_pass(digit, planes, counts, radix, tile, shift)
        want, _ = cr.onesweep_pass_plain(digit, planes, radix, tile, shift)
        err = max(max_abs_err(a, b) for a, b in zip(outs, want))
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
    m = n - 777
    x = torch.from_numpy(np.random.default_rng(1).integers(
        -2**31, 2**31, m).astype(np.int32)).to(dev)
    check(f"ragged n={m} (KV)", x, (x, iota[:m]), shift=24)
    check("17 planes n=2^22", x[:1 << 22],
          tuple(x[:1 << 22] + i for i in range(17)), radix=16, shift=4)
    ids = x & 255
    check("partition pass n=2^27-777 (ids not moved, 2 planes)", ids,
          (iota[:m], x))
    del x, ids, iota


def check_sorted_kv(rt, keys_in, keys_out, perm, host_keys, what):
    """On the device: sorted, same key multiset (sum + xor), payload is the
    permutation that produced the keys, stable within equal keys.  On the
    host: a 2^20 prefix against np.sort.  Sums and xors run on the
    sortable bits, a bijection of the keys that floats have too."""
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
                            np.sort(host_keys)[:pre].view(np.uint8)),
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


def _profile(fn, iters: int) -> list:
    """Device-side profiler events of ``iters`` calls of ``fn``."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    require(rows, "profiler recorded no device time")
    return rows


def _ms(rows, iters: int, pred=lambda e: True) -> float:
    return sum(e.device_time_total for e in rows if pred(e)) / iters / 1e3


def phase_profile(dev, rt):
    """A u32 KV sort at 2^27: its launches and host reads (one
    pass_histograms, four onesweep passes, one read), and torch.profiler's
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
    require(stream.host_reads - reads == 1, "a sort read the host "
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
          f"launches {delta}; host reads a sort 1", flush=True)
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


def phase_config3(dev, rt):
    from radix_sort_tpu_torch.ops import aggregate, filter as filt

    n = 1 << 26
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 1000, n).astype(np.uint32)
    vals = rng.integers(0, 100, n).astype(np.int32)
    t = rt.Table.from_numpy({"k": keys, "x": vals}, device=dev)

    def query(config=rt.DEFAULT_CONFIG):
        f = filt.filter_expr(t, "k", "lt", 500, config=config)
        return aggregate.hash_aggregate(
            f, "k", {"n": ("count", None), "s": ("sum", "x")}, config=config)

    out = query().to_numpy()
    mask = keys < 500
    exp_n = np.bincount(keys[mask], minlength=500)
    exp_s = np.bincount(keys[mask], weights=vals[mask], minlength=500)
    require(np.array_equal(out["k"], np.arange(500, dtype=np.uint32)),
            "config3: group keys differ")
    require(np.array_equal(out["n"], exp_n), "config3: counts differ")
    require(np.array_equal(out["s"], exp_s.astype(np.int32)),
            "config3: sums differ")
    torch_cfg = rt.SortConfig(engine="torch_sort")
    ms, ms_t = time_ms(query), time_ms(lambda: query(torch_cfg))
    print(f"[config3] filter(k<500) -> aggregate(count,sum) 2^26 rows: "
          f"validated vs np.bincount; {ms:.3f} ms ({n / ms / 1e3:.1f} "
          f"Mrows/s); with torch.sort inside {ms_t:.3f} ms "
          f"({n / ms_t / 1e3:.1f} Mrows/s)", flush=True)
    return ms, ms_t


def phase_config4(dev, rt):
    from radix_sort_tpu_torch.ops import join

    n_probe, n_build = 1 << 20, 1 << 18
    rng = np.random.default_rng(4)
    pk = rng.integers(0, n_probe >> 1, n_probe).astype(np.uint32)
    bk = rng.permutation(n_probe >> 1)[:n_build].astype(np.uint32)
    probe = rt.Table.from_numpy(
        {"k": pk, "pv": np.arange(n_probe, dtype=np.int32)}, device=dev)
    build = rt.Table.from_numpy(
        {"k": bk, "bv": (bk * 3).astype(np.int32)}, device=dev)

    def query(config=rt.DEFAULT_CONFIG):
        return join.hash_join(probe, build, "k", config=config)

    res, stats = query()
    cnt = int(stats["match_count"])
    out = res.to_numpy()
    require(cnt == int(np.isin(pk, bk).sum()), "config4: match count differs")
    require(not bool(stats["overflow"]), "config4: overflow")
    require(np.array_equal(out["bv"], (out["k"] * 3).astype(np.int32)),
            "config4: bv != 3k")
    torch_cfg = rt.SortConfig(engine="torch_sort")
    ms, ms_t = time_ms(query), time_ms(lambda: query(torch_cfg))
    print(f"[config4] hash_join 2^20 probe x 2^18 build: validated "
          f"({cnt} matches); {ms:.3f} ms ({n_probe / ms / 1e3:.1f} "
          f"Mrows/s); with torch.sort inside {ms_t:.3f} ms "
          f"({n_probe / ms_t / 1e3:.1f} Mrows/s)", flush=True)
    return ms, ms_t


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
    radix = run_path("radix", (lambda: phase_sort(dev, rt),
                               lambda: phase_profile(dev, rt),
                               lambda: phase_config3(dev, rt),
                               lambda: phase_config4(dev, rt)), radix_kernels)
    # the harness's per-phase timings run the three-launch pass
    merge = run_path("merge", (lambda: phase_merge(dev, rt),
                               lambda: phase_topk(dev, rt),
                               lambda: phase_harness(dev, rt)),
                     radix_kernels + ("digit_histogram", "exclusive_scan",
                                      "rank_scatter", "tile_sort",
                                      "merge_level"))
    launches = {k: radix[k] + merge[k] for k in REPLACES}
    peak = torch.cuda.max_memory_allocated()
    print(f"[summary] launches on both paths {launches}; "
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
