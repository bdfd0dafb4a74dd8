"""The run's last line: the contract's keys, the metrics read by their
readers, and the numbers compared beside their limits (last)."""

from __future__ import annotations

import dataclasses
import statistics
import sys

from . import trace as trace_lib

FORBIDDEN = ("jax", "jaxlib", "flax", "radix_sort_tpu")


@dataclasses.dataclass
class Run:
    """What a metric's reader gets: the cell, the run's result and its
    set-up seconds."""

    cell: object
    result: object
    setup_s: float

    @property
    def traced(self):
        """The traced reading, where its profiled stretch recorded device
        events; else None."""
        r = self.result.reading
        return r if r is not None and r.trace is not None and \
            r.trace.events else None


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``radix_sort_tpu_torch`` is not ``radix_sort_tpu``)."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def assemble(cell, res, setup_s: float, trace: bool, platform: str,
             extra: dict | None = None) -> dict:
    run = Run(cell, res, setup_s)
    limits = cell.reference.LIMITS
    checks = res.checks
    correct = (all(k in checks for k in limits)
               and all(checks[k] <= limits[k] for k in limits)
               and res.wrong == 0)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = cell.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": platform, "kind": res.device_name,
              "count": cell.chips, "memory_peak_bytes": res.peak_bytes}
    line = {"correct": bool(correct), "attempted": res.calls,
            "failed": res.wrong, "metrics": metrics, "device": device}
    reading = run.traced
    if trace and reading:
        # busy and traced seconds averaged over the cards; the breakdown
        # is the hot rank's, its names led by that rank
        traces = reading.rank_traces or [reading.trace]
        device["busy_s"] = statistics.fmean(
            t.busy_us() for t in traces) / 1e6
        device["window_s"] = statistics.fmean(
            t.span_us for t in traces) / 1e6
        lead = ("" if reading.hot_rank is None
                else f"rank {reading.hot_rank}: ")
        line["breakdown"] = {
            k: [[lead + n, s] for n, s in top(reading.trace)]
            for k, top in (("device_ops", trace_lib.top_ops),
                           ("idle_gaps", trace_lib.top_gaps))}
    line.update(extra or {})
    line["checks"] = {k: {"value": checks.get(k), "limit": limits[k]}
                      for k in limits}
    return line


def check_lines(line: dict) -> list:
    """The numbers compared, one line each, for the end of stderr."""
    return [f"check {k} {v['value']} limit {v['limit']}"
            for k, v in line["checks"].items()]
