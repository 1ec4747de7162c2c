"""device_ms_per_cycle: the device's busy time (the union of its kernel and
copy intervals in the profiler's trace) over whole traced solves, per cycle
of those solves; None without a device trace."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0.0 or t.cycles <= 0:
        return None
    return t.busy_s / t.cycles * 1e3
