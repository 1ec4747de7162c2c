"""fine_stencil_roofline: level 0's constant-stencil operator applied alone,
CUDA events over many launches; bound = x read once and y written once at
the card's memory bandwidth; in %. None where level 0 is no stencil or off
the card."""

from bench_port import roofline, trace


def read(run):
    A0 = run.state.hier.levels[0].A
    if run.device.type != "cuda" or not hasattr(A0, "offsets") or not hasattr(A0, "weights"):
        return None
    n = A0.shape[0]
    x = run.probe(n)
    seconds = trace.event_seconds(lambda: A0 @ x)
    return roofline.share_percent(roofline.stencil_bytes(n, x.element_size()), seconds,
                                  run.kind)
