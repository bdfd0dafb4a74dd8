"""port_kernel_ms: device ms a call in kernels that are neither PyTorch's
own library's (``trace.is_library``) nor NCCL's (``trace.is_collective``):
the program's hand-written kernels, whatever their names.  On several
cards, the hot rank's."""

from portbench import trace


def read(run):
    if not run.traced:
        return None
    return trace.per_call_ms(
        run.traced.trace,
        lambda n, k: k == trace.KERNEL and not trace.is_library(n)
        and not trace.is_collective(n))
