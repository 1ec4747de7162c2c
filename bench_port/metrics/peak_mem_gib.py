"""peak_mem_gib: torch.cuda.max_memory_allocated over set-up and window,
after a reset at the start of set-up, in GiB; None off the card."""


def read(run):
    if run.device.type != "cuda":
        return None
    return run.memory_peak_bytes / 2**30
