"""setup_host_s: host seconds of the run's set-up in the program's host
phases, all levels: `setup.rho`, `setup.strength`, `setup.coarsen`,
`setup.interp`, `setup.ideal`, `setup.transfers` and `setup.rap`. None off
the card, or where the program keeps no set-up record."""

from bench_port import spans


def read(run):
    return spans.setup_phases(run, spans.HOST_PHASES) if spans.on_card(run) else None
