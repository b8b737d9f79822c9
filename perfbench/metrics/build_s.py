"""Seconds of the port's build in set-up (build_index, ending in a
synchronise), host clock."""


def read(run):
    return run.build_s
