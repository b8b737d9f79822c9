"""Queries answered in the window over the window's seconds (host clock)."""


def read(run):
    return sum(b.rows for b in run.batches) / run.window_s
