"""filter_device_ms: device ms a call of the work launched under the
program's ``query.filter`` span (the query's filter step and every span
below it), in the stretch with the program's spans on.  None where the
program recorded no such span."""

from portbench import spans


def read(run):
    st = spans.stretch(run)
    if st is None:
        return None
    return spans.device_ms_under(st, "query.filter")
