"""host_enqueue_ms: host-clock ms from a call's start to the return of the
program's entry, before the answer is waited for; the mean over the
unprofiled calls of the traced run."""

import statistics


def read(run):
    r = run.result.reading
    if r is None or not r.enqueue_ms:
        return None
    return statistics.fmean(r.enqueue_ms)
