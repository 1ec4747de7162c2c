"""device_idle_share: 1 - device_ms_per_cycle / the host-clock ms per cycle
of the same run's unprofiled window, in %; None without a device trace."""

from bench_port.metrics import device_ms_per_cycle


def read(run):
    dev = device_ms_per_cycle.read(run)
    cycles = sum(s.iters for s in run.solves)
    if dev is None or cycles <= 0:
        return None
    wall_ms = sum(s.seconds for s in run.solves) / cycles * 1e3
    return 100.0 * (1.0 - dev / wall_ms)
