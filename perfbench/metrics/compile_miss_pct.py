"""The query compile cache's misses over the queries the port compiled,
in percent: the program's counters query.compile_miss and query.queries
(docodo_tpu_torch utils/profiling.counters), which set-up resets before
the build, so the reading covers the warm-up batches and the window.
None when the program keeps no such counters or compiled no query."""


def read(run):
    try:
        from docodo_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    c = counters()
    queries = c.get("query.queries", 0)
    if "query.compile_miss" not in c or not queries:
        return None
    return 100.0 * c["query.compile_miss"] / queries
