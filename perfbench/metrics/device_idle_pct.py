"""The share of the traced window in which no device operation ran, in
percent. None without a traced device."""


def read(run):
    tr = run.trace
    if tr is None or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
