"""ell_spmv_roofline: the matvec of the ELL level with the most nonzeros,
applied alone, CUDA events over many launches; bound = each true nonzero's
value and index once, x read once, y written once, at the card's memory
bandwidth; in %. The nonzeros are the level's host CSR's, not the ELL's
padded slots. None where no level is ELL or off the card."""

from bench_port import roofline, trace


def read(run):
    if run.device.type != "cuda":
        return None
    best = None
    for lv, hl in zip(run.state.hier.levels, run.state.hh.levels):
        if type(lv.A).__name__ == "ELLMatrix" and (best is None or hl.A.nnz > best[1].nnz):
            best = (lv.A, hl.A)
    if best is None:
        return None
    A, host = best
    x = run.probe(host.shape[1])
    seconds = trace.event_seconds(lambda: A @ x)
    nbytes = roofline.spmv_bytes(host.shape[0], host.shape[1], host.nnz, x.element_size())
    return roofline.share_percent(nbytes, seconds, run.kind)
