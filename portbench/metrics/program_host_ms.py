"""program_host_ms: host ms a call inside the program's outermost spans
(a sort entry, ``query``, ``to_host``), less the time waited in
``to_host.wait`` spans for the card, in the stretch with the program's
spans on.  None where the program recorded no span."""

from portbench import spans


def read(run):
    st = spans.stretch(run)
    if st is None:
        return None
    host = sum(b - a for _, a, b, _, parent in st.spans if parent is None)
    waited = sum(b - a for name, a, b, _, _ in st.spans
                 if name == "to_host.wait")
    return (host - waited) / 1e3 / st.trace.calls
