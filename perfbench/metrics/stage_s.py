"""Seconds of the staging in set-up (DeviceIndex.from_index, or with a
layout the sharded index's from_index over its cards), ending in a
synchronise of every card, host clock."""


def read(run):
    return run.stage_s
