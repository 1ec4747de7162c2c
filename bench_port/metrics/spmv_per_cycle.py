"""spmv_per_cycle: the program's `spmv.*` counters (one count per operator
apply, every format) summed over the span pass's solves, over the pass's
cycles (PCG iterations); the solves' start counts in. None off the card,
or where the program keeps no counters."""

from bench_port import spans


def read(run):
    return spans.spmv_per_cycle(run) if spans.on_card(run) else None
