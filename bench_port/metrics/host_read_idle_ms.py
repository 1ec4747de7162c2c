"""host_read_idle_ms: the device's idle time in the gaps that open while
the host is inside the program's `amg.host_read` span (the solve loop's
stop test), over the program's `host_read` counter (the reads the span
pass made: one a cycle, one more a PCG solve), in ms a read. None off the
card, or where the program keeps no spans."""

from bench_port import spans


def read(run):
    return spans.host_read_idle_ms(run) if spans.on_card(run) else None
