"""glue_device_ms: device ms a call in PyTorch's own library kernels
(``trace.is_library``: ATen, c10, cub, thrust), the torch ops the
program's operators are glued from.  On several cards, the hot rank's."""

from portbench import trace


def read(run):
    if not run.traced:
        return None
    return trace.per_call_ms(
        run.traced.trace,
        lambda n, k: k == trace.KERNEL and trace.is_library(n))
