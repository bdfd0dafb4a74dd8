"""call_p95_ms: the 95th percentile of every call's latency in the window
(CUDA events from the call's start to its answer, host work included)."""

from portbench import window


def read(run):
    return window.percentile(run.result.latencies_ms, 95)
