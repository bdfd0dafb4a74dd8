"""Benchmark CSV writer with the reference's exact schema.

Port of ``radix_sort_tpu/utils/csvio.py`` (the reference's
``writePerformance``, ``src/CRadixSortTask.cpp:316-353``).  The canonical
row is

  ``NumElements,Datatype,Dataset,avgHistogram,avgScan,avgPaste,avgReorder,
  avgTotalGPU,avgTotalSTLCPU,avgTotalRDXCPU``

(times in ms, averaged over the iterations), kept column for column so the
reference's aggregation tooling reads it, followed by the JAX package's
extra columns: throughput (Mkeys/s), roofline fraction of the device's
memory bandwidth, and engine name.  Files are named like the reference's
``radix_HH-MM-SS.csv`` (``src/CRadixSortTask.cpp:394-426``).
"""

from __future__ import annotations

import dataclasses
import datetime
import io
import os

REFERENCE_COLUMNS = (
    "NumElements", "Datatype", "Dataset",
    "avgHistogram", "avgScan", "avgPaste", "avgReorder",
    "avgTotalGPU", "avgTotalSTLCPU", "avgTotalRDXCPU",
)
EXTENDED_COLUMNS = REFERENCE_COLUMNS + (
    "MkeysPerSec", "RooflineFrac", "Engine",
)


@dataclasses.dataclass
class PerfRow:
    num_elements: int
    datatype: str
    dataset: str
    avg_histogram: float = 0.0
    avg_scan: float = 0.0
    avg_paste: float = 0.0
    avg_reorder: float = 0.0
    avg_total_gpu: float = 0.0
    avg_total_stl_cpu: float = 0.0
    avg_total_rdx_cpu: float = 0.0
    mkeys_per_sec: float = 0.0
    roofline_frac: float = 0.0
    engine: str = ""

    def reference_fields(self):
        return (
            self.num_elements, self.datatype, self.dataset,
            self.avg_histogram, self.avg_scan, self.avg_paste,
            self.avg_reorder, self.avg_total_gpu,
            self.avg_total_stl_cpu, self.avg_total_rdx_cpu,
        )

    def extended_fields(self):
        return self.reference_fields() + (
            self.mkeys_per_sec, self.roofline_frac, self.engine,
        )


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def write_rows(rows, stream: io.TextIOBase, extended: bool = True):
    cols = EXTENDED_COLUMNS if extended else REFERENCE_COLUMNS
    stream.write(",".join(cols) + "\n")
    for r in rows:
        fields = r.extended_fields() if extended else r.reference_fields()
        stream.write(",".join(_fmt(f) for f in fields) + "\n")


def timestamped_path(directory: str = ".", prefix: str = "radix") -> str:
    ts = datetime.datetime.now().strftime("%H-%M-%S")
    return os.path.join(directory, f"{prefix}_{ts}.csv")


def write_csv(rows, path: str | None = None, directory: str = ".",
              extended: bool = True) -> str:
    if path is None:
        path = timestamped_path(directory)
    with open(path, "w") as f:
        write_rows(rows, f, extended=extended)
    return path
