"""setup_s: host-clock seconds from the first call into the program's
set-up until its operators, smoother data and Chebyshev bounds are on the
device and one warm-up solve has run, synchronised. The inputs' generation
is not in it."""


def read(run):
    return run.setup_s
