"""peak_mem_gib: the program's peak of allocated device memory over the
window, in GiB: torch's ``max_memory_allocated`` (reset before the
window) less the answer the harness keeps for the check (``core.drive``),
so the caller's inputs, the program's work space and one call's answer."""


def read(run):
    return run.result.peak_bytes / 2**30
