"""Task orchestration harness.

Port of ``radix_sort_tpu/harness.py``, the reference's L2/L3 layers:

- the ``IComputeTask`` 5-phase contract (``Common/IComputeTask.h:12-35``):
  InitResources → ComputeCPU → ComputeGPU → ValidateResults →
  ReleaseResources, realised by :class:`SortTask` (``CRadixSortTask``,
  ``src/CRadixSortTask.h:22-92``);
- the ``CTestBase::RunComputeTask`` lifecycle (``tests/CTestBase.cpp:20-67``)
  → :func:`run_compute_task`;
- the ``CRunner`` fan-out over types × datasets (``tests/tests.cpp:29-88``)
  → :func:`run_all`.

"GPU" in names is the device the task was given (a CUDA card, or the CPU
where the tests run it); "CPU" is the host golden baselines (np.sort =
std::sort, golden radix = RadixSortCPU, or the native C++ baselines of
``native/`` when built).  The device is always explicit: nothing here picks
a card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import datasets as ds_lib, dtypes, golden
from .config import DEFAULT_CONFIG, SortConfig
from .ops import cuda_radix as cr, sort as sort_ops, stream
from .status import EngineError, OperationStatus
from .utils import native_baseline, profiling, stats as stats_lib
from .utils.cli import RadixSortOptions
from .utils.csvio import PerfRow


@dataclasses.dataclass
class TaskResult:
    row: PerfRow
    valid: bool
    status: OperationStatus


class SortTask:
    """One (dtype, dataset, n) sort job on ``device`` with golden validation
    and timing."""

    def __init__(self, dtype, dataset, options: RadixSortOptions | None = None,
                 config: SortConfig = DEFAULT_CONFIG, with_values: bool = True,
                 *, device):
        self.dtype = np.dtype(dtype)
        self.dataset = dataset
        self.device = torch.device(device)
        self.options = options or RadixSortOptions()
        self.config = config
        self.with_values = with_values
        self.gpu_runtimes = stats_lib.SortRuntimes()
        self.cpu_runtimes = stats_lib.CpuRuntimes()
        self._host_keys = None
        self._dev_keys = None
        self._dev_vals = None
        self._expected = None
        self._result = None

    # -- phase 1 ----------------------------------------------------------
    def init_resources(self):
        n = self.options.num_elements
        if n > self.config.max_input_elems:
            raise EngineError(OperationStatus.RESIZE_FAILED,
                              f"n={n} exceeds max_input_elems "
                              f"({self.config.max_input_elems})")
        self._host_keys = self.dataset.generate(n)
        self._dev_keys = dtypes.tensor_from_numpy(self._host_keys,
                                                  self.device)
        if self.with_values:
            self._dev_vals = torch.arange(n, dtype=torch.int32,
                                          device=self.device)

    # -- phase 2: host golden baselines ------------------------------------
    def compute_cpu(self):
        it = self.options.iterations

        def stl():
            self._expected = golden.oracle_sort(self._host_keys)

        self.cpu_runtimes.stl = stats_lib.time_callable_ms(
            stl, iterations=it, warmup=0)

        try:
            radix_fn = native_baseline.radix_sort_fn(self._host_keys)
        except ImportError:  # the native library is optional
            radix_fn = lambda: golden.cpu_radix_sort(self._host_keys)  # noqa
        self.cpu_runtimes.radix = stats_lib.time_callable_ms(
            radix_fn, iterations=it, warmup=0)

    # -- phase 3b: per-phase instrumentation --------------------------------
    def measure_phases(self):
        """Populate the per-kernel columns (avgHistogram / avgScan /
        avgReorder) by timing one pass of the radix kernels — digit
        histogram, the digit-major scan, rank + scatter of the key planes
        (and the payload) — and scaling by the pass count, as the reference
        reports per-kernel stats (src/RadixSortGPU.cpp:37-56).  avgPaste
        stays 0: the reference's paste kernel is folded into the scan.
        Diagnostic numbers: the sort itself skips degenerate passes."""
        cfg = self.config
        planes = stream.key_word_planes(dtypes.to_sortable(self._dev_keys))
        if self.with_values:
            planes += (self._dev_vals,)
        digit = planes[0]
        args = (cfg.radix, cfg.tile_elems, 0, cfg.threads_per_cta)
        hist = cr.digit_histogram(digit, *args)
        base = cr._stitch_block_base(hist)
        t_h = profiling.time_ms(lambda: cr.digit_histogram(digit, *args),
                                self.device)
        t_s = profiling.time_ms(lambda: cr._stitch_block_base(hist),
                                self.device)
        t_r = profiling.time_ms(
            lambda: cr.rank_scatter(digit, planes, base, *args[:3],
                                    threads=cfg.threads_per_cta),
            self.device)
        passes = cfg.num_passes(self.dtype)
        self.gpu_runtimes.histogram.update(t_h * passes)
        self.gpu_runtimes.scan.update(t_s * passes)
        self.gpu_runtimes.reorder.update(t_r * passes)

    # -- phase 3: device sort ---------------------------------------------
    def compute_gpu(self):
        cfg = self.config
        if self.with_values:
            def fn():
                return sort_ops.sort_kv(self._dev_keys, self._dev_vals,
                                        config=cfg)
        else:
            def fn():
                return sort_ops.sort(self._dev_keys, config=cfg)
        on_card = self.device.type == "cuda"

        def run():
            fn()
            if on_card:  # the call returns before the card is done
                torch.cuda.synchronize(self.device)

        self.gpu_runtimes.total = stats_lib.time_callable_ms(
            run, iterations=self.options.iterations, warmup=1)
        self._result = fn()

    # -- phase 4 -----------------------------------------------------------
    def validate_results(self) -> bool:
        n = self.options.num_elements
        if self._expected is None:
            self._expected = golden.oracle_sort(self._host_keys)
        out_keys = self._result[0] if self.with_values else self._result
        ok = golden.validate_bit_exact(dtypes.tensor_to_numpy(out_keys),
                                       self._expected, n)
        if self.with_values and ok:
            # the KV contract is the STABLE permutation, not just any
            # correct one
            perm = self._result[1].cpu().numpy()
            ok = bool(np.array_equal(
                perm, golden.oracle_argsort(self._host_keys)))
        return ok

    # -- phase 5 -----------------------------------------------------------
    def release_resources(self):
        self._dev_keys = None
        self._dev_vals = None
        self._result = None

    # -- reporting ---------------------------------------------------------
    def perf_row(self, valid: bool, engine_name: str,
                 hbm_bw_gbs: float | None = None) -> PerfRow:
        n = self.options.num_elements
        total_ms = self.gpu_runtimes.total.avg
        mkeys = (n / (total_ms / 1e3) / 1e6) if total_ms else 0.0
        roofline = 0.0
        if hbm_bw_gbs and total_ms:
            # the radix engine's work depends on the data: it skips each
            # pass one digit fills (all of them on Zeros)
            passes = (profiling.radix_passes_run(
                self._host_keys, self.config.bits_per_pass)
                if engine_name == "radix" else None)
            bytes_min = profiling.sort_min_bytes(
                n, self.dtype, self.config.bits_per_pass,
                payload_bytes=4 if self.with_values else 0, passes=passes)
            roofline = (bytes_min / (total_ms / 1e3)) / (hbm_bw_gbs * 1e9)
        return PerfRow(
            num_elements=n,
            datatype=dtypes.type_name(self.dtype),
            dataset=self.dataset.name,
            avg_histogram=self.gpu_runtimes.histogram.avg,
            avg_scan=self.gpu_runtimes.scan.avg,
            avg_paste=self.gpu_runtimes.paste.avg,
            avg_reorder=self.gpu_runtimes.reorder.avg,
            avg_total_gpu=total_ms,
            avg_total_stl_cpu=self.cpu_runtimes.stl.avg,
            avg_total_rdx_cpu=self.cpu_runtimes.radix.avg,
            mkeys_per_sec=mkeys,
            roofline_frac=roofline,
            engine=engine_name,
        )


def run_compute_task(task: SortTask, verbose: bool = False, *,
                     cpu_baselines: bool = True,
                     phases: bool = False) -> TaskResult:
    """CTestBase::RunComputeTask lifecycle (tests/CTestBase.cpp:20-67).
    ``cpu_baselines`` times the host baselines (the avgTotal*CPU columns);
    ``phases`` fills the per-kernel columns (``measure_phases``), as the
    benchmark sweep asks for them."""
    try:
        task.init_resources()
    except Exception as e:  # noqa: BLE001 - reported as the reference does
        raise EngineError(OperationStatus.INITIALIZATION_FAILED, str(e))
    if cpu_baselines:
        task.compute_cpu()
    task.compute_gpu()
    if phases:
        task.measure_phases()
    valid = task.validate_results()
    engine = sort_ops._dispatch_engine(task.config.engine)
    row = task.perf_row(valid, engine,
                        profiling.device_hbm_gbs(task.device))
    task.release_resources()
    if verbose:
        verdict = "VALID" if valid else "INVALID"
        print(f"{row.datatype:4s} {row.dataset:18s} n={row.num_elements} "
              f"{row.avg_total_gpu:10.3f} ms  {row.mkeys_per_sec:8.1f} Mkeys/s "
              f"[{verdict}]")
    return TaskResult(row=row, valid=valid,
                      status=OperationStatus.OK if valid
                      else OperationStatus.VALIDATION_FAILED)


def run_all(options: RadixSortOptions | None = None,
            config: SortConfig = DEFAULT_CONFIG,
            dtypes_list=(np.uint32, np.int32, np.uint64, np.int64),
            seed: int | None = 0, *, device):
    """CRunner::DoCompute fan-out on ``device``: all types x all five
    datasets (tests/tests.cpp:29-88).  Returns list[TaskResult]."""
    options = options or RadixSortOptions()
    results = []
    for dt in dtypes_list:
        name = dtypes.type_name(dt)
        if options.datatypes and name not in options.datatypes:
            continue
        for ds in ds_lib.make_datasets(dt, seed=seed):
            if options.datasets and ds.name not in options.datasets:
                continue
            task = SortTask(dt, ds, options=options, config=config,
                            device=device)
            results.append(run_compute_task(task, verbose=options.verbose))
    return results
