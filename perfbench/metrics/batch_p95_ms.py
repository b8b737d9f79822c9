"""The 95th percentile of every batch's latency in the window, from its
search_batch_full call to its finish() returning the answer (host clock,
ms; numpy's linear interpolation between order statistics)."""

import numpy as np


def read(run):
    lat = np.array([b.done - b.call for b in run.batches])
    return float(np.percentile(lat, 95) * 1e3) if lat.size else None
