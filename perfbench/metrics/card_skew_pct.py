"""How far the busiest card of a layout runs ahead of the cards' mean, in
percent: 100 x (the largest of the traced window's busy seconds by card
over their mean - 1). 0 when every card is as busy; it says whether one
shard sets the pace. None without a traced device or with one card."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    busy = list(getattr(tr, "busy_s_by_card", None) or ())
    if len(busy) < 2 or sum(busy) <= 0:
        return None
    return 100.0 * (max(busy) / (sum(busy) / len(busy)) - 1.0)
