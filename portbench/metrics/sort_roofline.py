"""sort_roofline: the whole sort's share of the memory roofline, in
percent: one read and one write of every key and payload byte a call
(2 n (key + payload bytes), whatever implements the sort) over the
device-busy time a call (the union of its device intervals), against the
card's published HBM bandwidth (``peaks.py``)."""

import numpy as np

from portbench import peaks, window


def read(run):
    if not run.traced:
        return None
    r = run.traced
    bw = peaks.hbm_bytes_per_s(r.device_name)
    if bw is None:
        return None
    t = run.cell.traffic
    key_bytes = np.dtype(run.cell.config["key_dtype"]).itemsize
    pay_bytes = np.dtype(t["payload"]).itemsize if t["payload"] else 0
    busy_s = r.trace.busy_us() / 1e6 / r.trace.calls
    return window.roofline_share(
        window.sort_bytes(t["n"], key_bytes, pay_bytes), busy_s, bw)
