"""The staged index's device memory: memory_allocated() after
DeviceIndex.from_index less before, in GiB. None off the card."""


def read(run):
    if run.device != "cuda":
        return None
    return run.index_bytes / float(1 << 30)
