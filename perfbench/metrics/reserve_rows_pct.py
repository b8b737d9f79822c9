"""The share of the sharded index's rows folded on the host because a
window chain may pass a shard's halo, in percent: the program's counters
mesh.reserve_rows over mesh.rows (docodo_tpu_torch utils/profiling
counters(), since set-up: the warm-up batches and the window). None when
the program keeps no such counters or served no row."""


def read(run):
    try:
        from docodo_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    c = counters()
    rows = c.get("mesh.rows", 0)
    if "mesh.reserve_rows" not in c or not rows:
        return None
    return 100.0 * c["mesh.reserve_rows"] / rows
