"""join_device_ms: device ms a call of the work launched under the
program's ``query.join`` span (both joins' sort, match and compaction,
and every span below them), in the stretch with the program's spans on.
None where the program recorded no such span."""

from portbench import spans


def read(run):
    st = spans.stretch(run)
    if st is None:
        return None
    return spans.device_ms_under(st, "query.join")
