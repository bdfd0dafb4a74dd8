"""Drive the PyTorch/CUDA port's main path once on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels of ``radix_sort_tpu_torch`` from ``csrc/`` (into
``build/kernels/``), holds each kernel bit-exact against its plain torch
version at the shapes the main path gives it, then runs the main path at
BASELINE sizes through the public entry points:

  - ``sort_kv``: u32 keys + int32 iota payload at 2^27 over the five
    ``datasets`` distributions, u64 keys at 2^27, and ``sort`` u32 key-only
    at 2^25, each timed beside ``engine="torch_sort"`` (torch.sort);
  - config 3: ``filter_expr(k < 500)`` → ``hash_aggregate(count, sum)`` over
    2^26 rows, checked against ``np.bincount``;
  - config 4: ``hash_join`` of a 2^20-row probe against a 2^18-row unique
    build, checked against numpy.

Every phase raises on a failure, so the exit code is non-zero and the last
line is not printed.  The last line is the JSON object
``{"ok": true, "device": {...}}``; the line before it lists each kernel with
its launch count on the main path and its time beside the plain version's.
Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SOURCE = "radix_sort_tpu_torch/csrc/radix.cu"
REPLACES = {
    "digit_histogram": "radix_sort_tpu/ops/pallas_radix.py:140",
    "exclusive_scan": "radix_sort_tpu/ops/pallas_radix.py:217",
    "rank_scatter": ("radix_sort_tpu/ops/pallas_radix.py:263; "
                     "radix_sort_tpu/ops/pallas_stream.py:427"),
}
REPS = 5


class SmokeFailure(RuntimeError):
    pass


def require(ok, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def time_ms(fn, reps: int = REPS) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm-up."""
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


def phase_build():
    from radix_sort_tpu_torch import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    print(f"[build] {path.name} in {time.perf_counter() - t0:.2f} s",
          flush=True)


def phase_kernels(dev, rt, cr):
    """Each kernel against its plain version on the same card tensors."""
    rng = np.random.default_rng(0)
    res = {k: {"max_abs_err": 0} for k in REPLACES}
    before = cr.launch_counts()

    def note(name, err, ms=None, plain_ms=None):
        r = res[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if ms is not None:
            r["ms"], r["plain_ms"] = ms, plain_ms

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
         time_ms(lambda: cr.digit_histogram(x, 256, 4096, 8)),
         time_ms(lambda: cr.digit_histogram_plain(x, 256, 4096, 8)))
    del x

    rb = 256 * ((1 << 27) // 4096)  # the (R*B) histogram of a 2^27 sort
    for m in (rb, 1000003):
        y = torch.from_numpy(rng.integers(0, 4096, m).astype(np.int32)).to(dev)
        err = max_abs_err(cr.exclusive_scan(y), cr.exclusive_scan_plain(y))
        require(err == 0, f"exclusive_scan n={m} disagrees")
        print(f"[kernels] exclusive_scan n={m}: bit-exact", flush=True)
        if m == rb:
            note("exclusive_scan", 0, time_ms(lambda: cr.exclusive_scan(y)),
                 time_ms(lambda: cr.exclusive_scan_plain(y)))

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
                 time_ms(lambda: cr.rank_scatter(keys, planes, base, 256,
                                                 4096, 0, with_dest=True)),
                 time_ms(lambda: cr.rank_scatter_plain(
                     keys, planes, base, 256, 4096, 0, with_dest=True)))
    after = cr.launch_counts()
    for name in REPLACES:
        require(after[name] > before[name], f"{name} launch counter idle")
    torch.cuda.synchronize()
    return res


def check_sorted_kv(rt, keys_in, keys_out, perm, host_keys, what):
    """On the device: sorted, same key multiset (sum + xor), payload is the
    permutation that produced the keys, stable within equal keys.  On the
    host: a 2^20 prefix against np.sort."""
    bi = rt.dtypes.as_container(keys_in)
    bo = rt.dtypes.as_container(keys_out)
    so = rt.dtypes.signed_order(rt.dtypes.to_sortable(keys_out))
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


def main() -> int:
    card = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    import radix_sort_tpu_torch as rt
    from radix_sort_tpu_torch.ops import cuda_radix as cr

    kernel_res = phase_kernels(dev, rt, cr)

    torch.cuda.reset_peak_memory_stats()
    cr.reset_launch_counts()
    phase_sort(dev, rt)
    phase_config3(dev, rt)
    phase_config4(dev, rt)
    torch.cuda.synchronize()
    launches = cr.launch_counts()
    for name, count in launches.items():
        require(count > 0, f"{name} never launched on the main path")
    peak = torch.cuda.max_memory_allocated()
    print(f"[summary] main-path launches {launches}; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB; card {card}",
          flush=True)

    kernels = [{"name": name, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"]}
               for name, r in kernel_res.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
