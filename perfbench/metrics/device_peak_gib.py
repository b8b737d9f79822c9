"""The allocator's peak over the window (torch.cuda.max_memory_allocated
after reset_peak_memory_stats at its start), staged index included, in
GiB; over several cards the fullest card's. None off the card."""


def read(run):
    if run.device != "cuda":
        return None
    return run.peak_bytes / float(1 << 30)
