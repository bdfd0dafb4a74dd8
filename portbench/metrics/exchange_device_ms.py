"""exchange_device_ms: device ms a call in NCCL's kernels (``trace.
is_collective``: the all-to-alls, all-gathers and all-reduces of the
distributed layer) on the hot rank, the card with the most device time a
call outside them, which the other ranks' NCCL kernels wait for.  None where the stretch holds no such kernel (gloo ranks)."""

from portbench import trace


def read(run):
    if not run.traced:
        return None
    t = run.traced.trace
    if not any(trace.is_collective(n) for n, _, _, _ in t.events):
        return None
    return trace.per_call_ms(
        t, lambda n, k: k == trace.KERNEL and trace.is_collective(n))
