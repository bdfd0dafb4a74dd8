"""rank_imbalance: the most device ms a call outside NCCL's kernels
(``Trace.work_us``) of any rank over the mean of the ranks' (each rank's
profiled stretch, the same calls): 1 when the ranks share the work
evenly; what the skew of the keys costs the card that sets the pace.
Device-busy time would read 1 whatever the skew: a NCCL kernel runs on
while it waits for the slowest rank.  None on one card."""

import statistics


def read(run):
    r = run.traced
    if r is None or not r.rank_traces:
        return None
    work = [t.work_us() / t.calls for t in r.rank_traces]
    return max(work) / statistics.fmean(work)
