#!/usr/bin/env python
"""Headline benchmark of the PyTorch/CUDA port: u32 sort, 2^25
uniform-random keys, the reference's flagship row
(Performance/performance_uniform.csv:101: 740.664 ms on a GTX 680 → 45.3
Mkeys/s).  The port's counterpart of ``bench.py``.  Prints ONE JSON line:

  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...audit...}

    python bench_torch.py                      # on the card, engine auto
    python bench_torch.py --engine merge       # or radix / torch_sort
    python bench_torch.py --log2n 12 --device cpu

``vs_baseline`` is the keys/s over the reference's 45.3 Mkeys/s.  The keys
are ``datasets.RandomDistributed(np.uint32, seed=0)``, the bytes
``bench.py`` sorts.

Timing: CUDA events around warmed calls on the card (the host clock on the
CPU, where ``--device cpu`` asks for it): ``CALLS`` samples, each the mean
of ``BATCH`` back-to-back sorts inside one event pair; the value is taken
from the median sample.  Self-check: if the samples' spread (max - min) /
median exceeds 10%, the measurement is taken again, up to 4 times in all,
and the line then says ``"suspect": true``.  ``torch_sort_ms`` times
``torch.sort(stable=True)`` of the same keys on the same device the same
way.

Validation, as ``bench.py``'s: on the device, the output is sorted and its
sum and xor equal the input's; on the host, a 2^20 prefix equals
``np.sort``'s.  A failure exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

BASELINE_MKEYS_PER_SEC = 33_554_432 / 0.740664 / 1e6  # 45.30 Mkeys/s
LOG2N = 25
CALLS = 10
BATCH = 5
SPREAD = 0.10
ATTEMPTS = 4


def sample_ms(fn, dev) -> list:
    """``CALLS`` samples of one call's ms, each the mean over ``BATCH``
    back-to-back calls (one warm-up batch first)."""
    from radix_sort_tpu_torch.utils import profiling

    def run():
        for _ in range(BATCH):
            fn()

    return [t / BATCH for t in profiling.call_times(run, dev, CALLS)]


def measure(fn, dev):
    """(samples, suspect): samples re-taken while their spread exceeds
    ``SPREAD``, ``ATTEMPTS`` times at most."""
    for attempt in range(ATTEMPTS):
        ms = sample_ms(fn, dev)
        spread = (max(ms) - min(ms)) / float(np.median(ms))
        if spread <= SPREAD:
            return ms, False
        print(f"# suspect timing attempt {attempt}: spread {spread:.3f} of "
              f"the median over {CALLS} samples (min {min(ms):.4f} ms, max "
              f"{max(ms):.4f} ms) - retry", flush=True)
    return ms, True


def run(log2n: int = LOG2N, engine: str = "auto",
        device: str = "cuda") -> dict:
    """Sort, validate and time the headline keys; the JSON record.  Raises
    SystemExit when the validation fails."""
    import radix_sort_tpu_torch as rt
    from radix_sort_tpu_torch.utils import cli, profiling

    import chip_smoke

    dev = cli.resolve_device(device)
    n = 1 << log2n
    data = rt.datasets.RandomDistributed(np.uint32, seed=0).generate(n)
    keys = rt.dtypes.tensor_from_numpy(data, dev)

    out = rt.sort(keys, engine=engine)
    try:
        chip_smoke.check_sorted_kv(rt, keys, out, None, data,
                                   f"u32 2^{log2n} engine={engine}")
    except chip_smoke.SmokeFailure as e:
        raise SystemExit(f"validation failed: {e}")
    del out

    ms, suspect = measure(lambda: rt.sort(keys, engine=engine), dev)
    med = float(np.median(ms))
    torch_ms = float(np.median(sample_ms(
        lambda: rt.sort(keys, engine="torch_sort"), dev)))
    mkeys = n / (med / 1e3) / 1e6
    card = profiling.device_info(dev)
    return {
        "metric": f"u32_sort_2^{log2n}_uniform_throughput",
        "value": round(mkeys, 2),
        "unit": "Mkeys/s",
        "vs_baseline": round(mkeys / BASELINE_MKEYS_PER_SEC, 2),
        "engine": engine,
        "ms_median": med, "ms_min": min(ms), "ms_max": max(ms),
        "calls": len(ms), "batch": BATCH, "suspect": suspect,
        "torch_sort_ms": torch_ms, "vs_torch_sort": torch_ms / med,
        "name": card["name"], "power_limit_w": card["power_limit_w"],
    }


def main(argv=None) -> int:
    from radix_sort_tpu_torch.utils import cli

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2n", type=int, default=LOG2N)
    ap.add_argument("--engine", default="auto", choices=cli.ENGINE_CHOICES)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.log2n, args.engine, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
