"""Host milliseconds a batch of the sharded index's merge on its first
card (laying the shards' runs and hits out as one index's, the rank top
k, the document grouping and the readback, as the host enqueues them):
the program's always-on phase mesh.merge over its counter mesh.batches
(docodo_tpu_torch utils/profiling report() and counters(), which set-up
resets before the build, so the reading covers the warm-up batches and
the window). None when the program keeps no such phase or counter."""


def read(run):
    try:
        from docodo_tpu_torch.utils.profiling import counters, report
    except ImportError:
        return None
    batches = counters().get("mesh.batches", 0)
    merge = [total for name, total, _ in report() if name == "mesh.merge"]
    if not batches or not merge:
        return None
    return 1e3 * merge[0] / batches
