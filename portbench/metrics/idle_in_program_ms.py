"""idle_in_program_ms: device-idle ms a call while a program span was open
on the host (the idle gaps between the stretch's device events, the part
of each that overlaps a span), in the stretch with the program's spans
on.  None where the program recorded no span."""

from portbench import spans


def read(run):
    st = spans.stretch(run)
    if st is None:
        return None
    return sum(spans.attribute(st).idle_us) / 1e3 / st.trace.calls
