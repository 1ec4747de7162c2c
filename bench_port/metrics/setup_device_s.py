"""setup_device_s: host seconds of the run's set-up in the program's
`setup.device` (device formats, upload, coarse inverse) and `setup.cheby`
(the Chebyshev bounds) phases, each ended by a synchronisation. None off
the card, or where the program keeps no set-up record."""

from bench_port import spans


def read(run):
    return spans.setup_phases(run, spans.DEVICE_PHASES) if spans.on_card(run) else None
