"""Runtime options, parity with ``RadixSortOptions`` (``src/RadixSortOptions.h:8-40``).

Port of ``radix_sort_tpu/utils/cli.py``: the reference's flags
``--num-elements`` (default 2^25), ``--perf-to-stdout``, ``--perf-to-csv``,
``--perf-csv-to-stdout`` and ``-v/--verbose`` on argparse, plus the JAX
package's additions (engine, dtype/dataset filters, bits per pass,
iterations, CSV directory) with the same defaults.  ``--engine`` offers the
port's engines.  :func:`resolve_device` reads the ``--device`` of the
port's entry points (``bench_torch.py``, ``scripts/torch_*.py``).
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

ENGINE_CHOICES = ("auto", "radix", "merge", "torch_sort")


@dataclasses.dataclass
class RadixSortOptions:
    num_elements: int = 1 << 25
    perf_to_stdout: bool = False
    perf_to_csv: bool = False
    perf_csv_to_stdout: bool = False
    verbose: bool = False
    engine: str = "auto"
    bits_per_pass: int = 8
    datatypes: tuple = ("u32", "i32", "u64", "i64")
    datasets: tuple = ()
    iterations: int = 5
    csv_dir: str = "."


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="radix_sort_tpu_torch",
        description="radix-sort / query-execution benchmark harness "
                    "(PyTorch + CUDA)",
    )
    p.add_argument("--num-elements", type=int, default=1 << 25)
    p.add_argument("--perf-to-stdout", action="store_true")
    p.add_argument("--perf-to-csv", action="store_true")
    p.add_argument("--perf-csv-to-stdout", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--engine", default="auto", choices=ENGINE_CHOICES)
    p.add_argument("--bits-per-pass", type=int, default=8)
    p.add_argument("--datatypes", default="u32,i32,u64,i64")
    p.add_argument("--datasets", default="")
    p.add_argument("--iterations", type=int, default=5)
    p.add_argument("--csv-dir", default=".")
    return p


def parse_options(argv=None) -> RadixSortOptions:
    a = build_parser().parse_args(argv)
    return RadixSortOptions(
        num_elements=a.num_elements,
        perf_to_stdout=a.perf_to_stdout,
        perf_to_csv=a.perf_to_csv,
        perf_csv_to_stdout=a.perf_csv_to_stdout,
        verbose=a.verbose,
        engine=a.engine,
        bits_per_pass=a.bits_per_pass,
        datatypes=tuple(s for s in a.datatypes.split(",") if s),
        datasets=tuple(s for s in a.datasets.split(",") if s),
        iterations=a.iterations,
        csv_dir=a.csv_dir,
    )


def resolve_device(name: str) -> torch.device:
    """The device an entry point's ``--device`` names ("cuda", "cuda:1",
    "cpu").  A CUDA device where no card is visible raises: a program runs
    on the CPU only when the caller asks for it."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {name}: no CUDA card is visible "
                               f"(torch.cuda.is_available() is false); pass "
                               f"--device cpu to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
