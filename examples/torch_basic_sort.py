"""Canonical library consumer on the PyTorch/CUDA port — the same program
as examples/basic_sort.py (the reference's basic_sort example,
examples/basic_sort/basic_sort.cpp:23-162): dataset → upload → sort →
verify → timings.

The sort runs on the card (``--device cuda``, the default) through the
hand-written radix kernels, and is timed with CUDA events around warmed
calls; ``--device cpu`` runs the kernels' plain versions and times with
the host clock.

Run: python examples/torch_basic_sort.py [--num-elements N] [--engine E]
                                         [--device cuda|cpu]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import numpy as np


def _elapsed_ms(fn, reps: int, on_card: bool) -> float:
    """Mean time of one of ``reps`` back-to-back calls of ``fn`` after a
    warm-up: CUDA events on the card, the host clock on the CPU."""
    import torch

    fn()
    if on_card:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def main():
    import torch

    from radix_sort_tpu_torch import golden, sort_kv
    from radix_sort_tpu_torch.config import SortConfig
    from radix_sort_tpu_torch.datasets import RandomDistributed
    from radix_sort_tpu_torch.dtypes import tensor_from_numpy, tensor_to_numpy
    from radix_sort_tpu_torch.utils.cli import build_parser

    parser = build_parser()
    parser.add_argument("--device", default="cuda")
    opts = parser.parse_args()
    n = min(opts.num_elements, 1 << 20) if opts.num_elements == 1 << 25 \
        else opts.num_elements
    device = torch.device(opts.device)
    on_card = device.type == "cuda"
    print(torch.cuda.get_device_name(device) if on_card else "cpu")

    # 1. dataset (uniform with planted min/max, like the reference example)
    data = RandomDistributed(np.uint32, seed=42).generate(n)
    values = np.arange(n, dtype=np.int32)

    # 2. upload
    keys_dev = tensor_from_numpy(data, device)
    vals_dev = tensor_from_numpy(values, device)

    # 3. sort (key-value: the payload rides along)
    cfg = SortConfig(engine=opts.engine)
    out_k, out_v = sort_kv(keys_dev, vals_dev, config=cfg)
    elapsed = _elapsed_ms(lambda: sort_kv(keys_dev, vals_dev, config=cfg),
                          9, on_card)

    # 4. download + verify vs the std::sort-equivalent oracle
    host_k = tensor_to_numpy(out_k)
    host_v = tensor_to_numpy(out_v)
    expected = golden.oracle_sort(data)
    perm = golden.oracle_argsort(data)
    ok = golden.validate_bit_exact(host_k, expected, n) and \
        np.array_equal(host_v, perm.astype(np.int32))

    # 5. report
    print(f"sorted {n} u32 key-value pairs in {elapsed:.3f} ms "
          f"({n / max(elapsed, 1e-9) / 1e3:.1f} Mkeys/s)")
    print("validation:", "OK" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
