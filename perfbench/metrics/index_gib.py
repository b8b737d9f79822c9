"""The staged index's device memory: memory_allocated() after staging
less before, in GiB; over several cards the fullest card's. None off the
card."""


def read(run):
    if run.device != "cuda":
        return None
    return run.index_bytes / float(1 << 30)
