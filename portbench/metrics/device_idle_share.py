"""device_idle_share: 1 - (the union of the device's kernel, memset and
memcpy intervals) / (the profiled stretch's span on the device's
timeline), in percent.  On several cards, the hot rank's."""


def read(run):
    if not run.traced:
        return None
    return 100.0 * run.traced.trace.idle_share()
