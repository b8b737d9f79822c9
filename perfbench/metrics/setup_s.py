"""Seconds from the start of the process's harness to the first timed
batch: the corpus, the port's build, staging, the query pool and the
warm-up batches (host clock)."""


def read(run):
    return run.setup_s
