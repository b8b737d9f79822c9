"""The window's queries' least time over the card's kernel-busy time, in
percent: the least time is the bytes the queries need (work.py: every
posting list named, read once; every answer written once; the page ends
once a batch; the same count whatever layout serves them) over one
card's HBM bandwidth (peaks.json), and the kernel-busy time is the union
of the traced window's kernel intervals on each card, summed over the
cards. None without a traced device."""


def read(run):
    tr = run.trace
    if tr is None or tr.kernel_busy_s <= 0:
        return None
    least = run.bytes_moved / run.peaks["hbm_bytes_per_s"]
    return 100.0 * least / tr.kernel_busy_s
