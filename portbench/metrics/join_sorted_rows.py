"""join_sorted_rows: the rows that enter the joins' sorts a call, the
growth of the program's ``ops/join.py`` counter ``sorted_rows`` (probe
and build capacity, padding included; the mix's ``counters()``) over the
unprofiled calls of the traced run.  None where the program counts
none."""


def read(run):
    r = run.result.reading
    if r is None or "join_sorted_rows" not in r.counters:
        return None
    return r.counters["join_sorted_rows"]
