"""The share of the traced window in which no device operation ran, in
percent; over several cards the mean of each card's share (trace.read's
busy seconds are the cards' mean). None without a traced device."""


def read(run):
    tr = run.trace
    if tr is None or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
