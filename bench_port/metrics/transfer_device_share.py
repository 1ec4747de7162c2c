"""transfer_device_share: device time of the kernels launched inside the
program's `amg.restrict:*` and `amg.prolong:*` spans (an additive level's
whole restriction and prolongation chains), over the span pass's device
busy time, in %. None off the card, or where the program keeps no spans."""

from bench_port import spans


def read(run):
    return spans.transfer_device_share(run) if spans.on_card(run) else None
