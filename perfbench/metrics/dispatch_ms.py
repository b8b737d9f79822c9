"""Mean host milliseconds of the deferred search_batch_full call a batch
(the query compile, bucketing and every launch), timed from the harness."""


def read(run):
    if not run.batches:
        return None
    return 1e3 * sum(b.dispatched - b.call for b in run.batches) / len(
        run.batches)
