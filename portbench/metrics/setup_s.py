"""setup_s: host-clock seconds from the run's start (before Python imports
torch) to the window's start: imports, the card's context, the kernel
library (built in a checkout's first run), inputs made on the card from
the seed, and the cell's own shapes warmed up."""


def read(run):
    return run.setup_s
