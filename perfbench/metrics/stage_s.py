"""Seconds of DeviceIndex.from_index in set-up, ending in a synchronise,
host clock."""


def read(run):
    return run.stage_s
