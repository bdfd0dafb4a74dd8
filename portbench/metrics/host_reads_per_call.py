"""host_reads_per_call: the program's host reads a call on rank 0, the
growth of ``exchange.host_reads + stream.host_reads`` (the mix's
``counters()``: split sizes and row counts read back to size an output)
over the unprofiled calls of the traced run.  None where the mix counts
none."""


def read(run):
    r = run.result.reading
    if r is None or "host_reads" not in r.counters:
        return None
    return r.counters["host_reads"]
