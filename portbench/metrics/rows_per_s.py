"""rows_per_s: every input row of every call completed in the window, over
the window's host-clock seconds, in millions."""

from portbench import window


def read(run):
    rows = run.result.calls * run.cell.mix.rows_per_call(run.cell)
    return window.rate(rows, run.result.window_s) / 1e6
