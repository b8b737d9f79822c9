"""Mean milliseconds of a batch's finish() (the wait for its copies and
the scatter into the numpy answer), timed from the harness."""


def read(run):
    if not run.batches:
        return None
    return 1e3 * sum(b.done - b.finish0 for b in run.batches) / len(
        run.batches)
