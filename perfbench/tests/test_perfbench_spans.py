"""spans.py on a made-up profile with correlation ids and threads: device
work goes to the program span that launched it, not to the span the
host is in while it runs; idle gaps go to the innermost program span;
blocking runtime calls are counted by span; trace.read and the existing
readers read the same with the new reader; the span metrics are None
without a trace. Also the program-counter reader compile_miss_pct and
span_run's window deltas."""

import numpy as np
import pytest

from perfbench import harness, span_run, spans, trace, work
from perfbench.tests.test_perfbench_trace import Ev, Prof

MAIN, OS_TID = 1, 4242


class CEv(Ev):
    """An event with a correlation id, a linked (torch op's) id and a
    thread, as the profiler's kineto events carry them."""

    def __init__(self, name, dev, s, t, annotation=False, corr=0,
                 linked=0, tid=MAIN):
        super().__init__(name, dev, s, t, annotation)
        self._c, self._l, self._tid = corr, linked, tid

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l

    def start_thread_id(self):
        return self._tid


def events():
    return [
        # the harness: dispatch 0-100, finish 100-150, dispatch 160-300
        CEv("bench.dispatch", "CPU", 0, 100, True),
        CEv("bench.finish", "CPU", 100, 150, True),
        CEv("bench.between", "CPU", 150, 160, True),
        CEv("bench.dispatch", "CPU", 160, 300, True),
        CEv("bench.dispatch", "CUDA", 0, 300, True),
        # the program: batch 0's dispatch 5-95, compile 5-30, upload
        # 30-50, launch 50-90 (fetch 55-70, merge 70-85); its finish
        # inside bench.finish; batch 1's dispatch 165-290, compile
        # 165-260, the collector 200-240 inside it
        CEv("query.dispatch", "CPU", 5, 95, True),
        CEv("query.compile", "CPU", 5, 30, True),
        CEv("query.upload", "CPU", 30, 50, True),
        CEv("query.launch", "CPU", 50, 90, True),
        CEv("route.fetch", "CPU", 55, 70, True),
        CEv("route.merge", "CPU", 70, 85, True),
        CEv("query.finish", "CPU", 105, 145, True),
        CEv("query.finish.wait", "CPU", 105, 140, True),
        CEv("query.dispatch", "CPU", 165, 290, True),
        CEv("query.compile", "CPU", 165, 260, True),
        CEv("host.gc", "CPU", 200, 240, True),
        CEv("query.launch", "CPU", 260, 285, True),
        # GPU-side copies of program annotations: not device work
        CEv("route.fetch", "CUDA", 60, 200, True),
        # torch ops, on the profiler's thread ids
        CEv("aten::index", "CPU", 56, 60, corr=101, tid=MAIN),
        CEv("aten::cat", "CPU", 71, 74, corr=102, tid=MAIN),
        # runtime calls, on the OS's thread id, linked to their torch op
        CEv("cudaLaunchKernel", "CPU", 57, 58, corr=11, linked=101,
            tid=OS_TID),
        CEv("cudaLaunchKernel", "CPU", 72, 73, corr=12, linked=102,
            tid=OS_TID),
        CEv("cudaLaunchKernel", "CPU", 270, 271, corr=13),
        CEv("cudaLaunchKernel", "CPU", 152, 153, corr=14),
        CEv("cudaStreamSynchronize", "CPU", 32, 48, corr=15),
        CEv("cudaMemcpyAsync", "CPU", 31, 32, corr=16),
        CEv("cudaEventSynchronize", "CPU", 106, 139, corr=17),
        CEv("cudaHostAlloc", "CPU", 120, 124, corr=18),
        # device work: the fetch's kernel runs 60-80 (while the host is in
        # route.merge), the merge's 80-100 (while it is in query.dispatch
        # and bench.finish), a copy of the upload 35-40, one kernel of
        # batch 1's launch 275-300, one launched between the harness's
        # spans 155-158, one whose call the trace lost 10-12
        CEv("k_fetch", "CUDA", 60, 80, corr=11),
        CEv("k_merge", "CUDA", 80, 100, corr=12),
        CEv("Memcpy HtoD (Pageable -> Device)", "CUDA", 35, 40, corr=16),
        CEv("k_late", "CUDA", 275, 300, corr=13),
        CEv("k_between", "CUDA", 155, 158, corr=14),
        CEv("k_lost", "CUDA", 10, 12, corr=99),
    ]


def test_device_time_goes_to_the_launching_span():
    sp = spans.read(Prof(events()))
    dev = sp.device
    assert np.isclose(dev["route.fetch"], 20e-9)
    assert np.isclose(dev["route.merge"], 20e-9)
    assert np.isclose(dev["query.upload"], 5e-9)
    assert np.isclose(dev["query.launch"], 25e-9)
    assert np.isclose(dev[spans.UNATTRIBUTED], (3 + 2) * 1e-9)
    assert np.isclose(sum(dev.values()), sp.device_s)
    # busy: [10, 12], [35, 40], [60, 100], [155, 158], [275, 300]
    assert np.isclose(sp.busy_s, (2 + 5 + 40 + 3 + 25) * 1e-9)
    assert sp.batches == 2
    m = spans.metrics(sp)
    assert np.isclose(m["fetch_busy_pct"], 100 * 20 / 75)
    sh = spans.shares(sp, trace.read(Prof(events())))
    assert np.isclose(sh["device_attributed"], 1 - 5 / 75)
    # idle in bench.dispatch: [0, 10], [12, 35], [40, 60], [160, 275];
    # of its 168 ns, 10 are in no program span
    assert np.isclose(sh["dispatch_idle_named"], 1 - 10 / 168)


def test_idle_gaps_go_to_the_innermost_span():
    sp = spans.read(Prof(events()))
    idle = sp.idle
    # gaps [0, 10], [12, 35], [40, 60], [100, 155], [158, 275]
    assert np.isclose(idle["bench.dispatch"], (5 + 5) * 1e-9)
    assert np.isclose(idle["query.compile"], (5 + 18 + 35 + 20) * 1e-9)
    assert np.isclose(idle["query.upload"], (5 + 10) * 1e-9)
    assert np.isclose(idle["query.launch"], (5 + 15) * 1e-9)
    assert np.isclose(idle["route.fetch"], 5e-9)
    assert np.isclose(idle["query.finish.wait"], 35e-9)
    assert np.isclose(idle["query.finish"], 5e-9)
    assert np.isclose(idle["bench.finish"], (5 + 5) * 1e-9)
    assert np.isclose(idle["bench.between"], (5 + 2) * 1e-9)
    assert np.isclose(idle["host.gc"], 40e-9)
    # the gaps are trace.read's: the same seconds in all
    tr = trace.read(Prof(events()))
    assert np.isclose(sum(idle.values()), sum(tr.idle.values()))
    assert np.isclose(sum(idle.values()), tr.window_s - tr.busy_s)


def test_host_seconds_and_waits():
    sp = spans.read(Prof(events()))
    total, own, calls, longest = sp.host["query.dispatch"]
    assert calls == 2 and np.isclose(total, (90 + 125) * 1e-9)
    assert np.isclose(longest, 125e-9)
    assert np.isclose(own, (5 + 5) * 1e-9)
    assert np.isclose(sp.host["query.compile"][1], (25 + 55) * 1e-9)
    assert np.isclose(sp.host["host.gc"][0], 40e-9)
    assert sp.waits[("query.upload", "cudaStreamSynchronize")] == (
        1, pytest.approx(16e-9))
    assert sp.waits[("query.finish.wait", "cudaEventSynchronize")] == (
        1, pytest.approx(33e-9))
    assert ("query.finish.wait", "cudaHostAlloc") in sp.waits
    assert not any(c == "cudaMemcpyAsync" for _, c in sp.waits)
    m = spans.metrics(sp)
    assert np.isclose(m["compile_ms"], 1e3 * (25 + 95) * 1e-9 / 2)
    assert np.isclose(m["upload_ms"], 1e3 * 20e-9 / 2)
    assert np.isclose(m["launch_ms"], 1e3 * (40 + 25) * 1e-9 / 2)
    assert np.isclose(m["gc_ms"], 1e3 * 40e-9 / 2)
    bd = spans.breakdown(sp)
    assert set(bd) == {"device_by_span", "idle_by_span", "waits_by_span"}
    assert all(len(v) <= 10 for v in bd.values())
    assert bd["device_by_span"][0][0] == "query.launch"
    assert bd["waits_by_span"][0] == [
        "query.finish.wait: cudaEventSynchronize", 1, pytest.approx(33e-9)]


def test_trace_read_and_readers_unchanged_by_the_new_reader():
    def readings(prof):
        tr = trace.read(prof)
        run = harness.Run(setup_s=1.0, build_s=0.5, stage_s=0.2,
                          index_bytes=2**30, batches=[], window_s=1.0,
                          peak_bytes=2**31, bytes_moved=10**6, trace=tr,
                          peaks=work.peaks(), device="cuda")
        return tr, trace.breakdown(tr), [harness.reader(m)(run) for m in (
            "query_roofline_pct", "device_idle_pct", "index_gib",
            "device_peak_gib")]

    prof = Prof(events())
    before = readings(prof)
    spans.read(prof)
    assert readings(prof) == before
    # the program's spans do not move trace.read: the same events without
    # them read the same
    bare = [e for e in events() if not spans.is_program(e.name())]
    assert readings(Prof(bare)) == readings(Prof(events()))


def test_span_metrics_none_without_a_trace():
    assert all(v is None for v in spans.metrics(None).values())
    assert set(spans.metrics(None)) == {"compile_ms", "upload_ms",
                                        "launch_ms", "gc_ms",
                                        "fetch_busy_pct"}
    no_batch = [e for e in events() if e.name() != "query.dispatch"]
    assert all(v is None for v in spans.metrics(
        spans.read(Prof(no_batch))).values())
    with pytest.raises(ValueError):
        spans.read(Prof([e for e in events()
                         if not e.name().startswith("bench.")]))


def test_blocking_calls():
    for name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                 "cudaEventSynchronize", "cudaMalloc", "cudaFree",
                 "cudaHostAlloc", "cudaMemcpy"):
        assert spans.is_blocking(name), name
    for name in ("cudaMemcpyAsync", "cudaLaunchKernel", "cudaMallocAsync",
                 "cuLaunchKernel"):
        assert not spans.is_blocking(name), name
    assert spans.is_runtime("cuLaunchKernel")
    assert not spans.is_runtime("cumsum") and not spans.is_runtime("aten::x")


def test_compile_miss_pct_reads_the_program_counters():
    from docodo_tpu_torch.utils import profiling

    read = harness.reader("compile_miss_pct")
    profiling.reset()
    assert read(None) is None
    profiling.count("query.queries", 8)
    profiling.count("query.compile_miss", 2)
    assert read(None) == 25.0
    profiling.reset()


def test_window_deltas():
    a = {"counters": {"query.batches": 2}, "gc_collections": [5, 1, 0],
         "device_allocator": {"num_device_alloc": 7}}
    b = {"counters": {"query.batches": 9, "query.queries": 4},
         "gc_collections": [8, 1, 1],
         "device_allocator": {"num_device_alloc": 7}}
    assert span_run.deltas(a, b) == {
        "counters": {"query.batches": 7, "query.queries": 4},
        "gc_collections": [3, 0, 1],
        "device_allocator": {"num_device_alloc": 0}}


def test_span_run_on_the_cpu():
    """A whole span_run on the CPU at the tests' size: run.py's traced
    result with the program's spans read, the counters as window deltas
    and trace.read unchanged by the second reader."""
    from perfbench.tests.conftest import SMALL_CONFIG, SMALL_PARAMS

    res = span_run.run("books-1g.and-high", 2**31 + 7, 1.0, device="cpu",
                       config=SMALL_CONFIG, params=SMALL_PARAMS)
    assert res["correct"] is True
    assert {"device_ops", "idle_gaps", "device_by_span", "idle_by_span",
            "waits_by_span"} == set(res["breakdown"])
    notes = res["notes"]
    assert notes["trace_read_unchanged"] is True
    assert 0.9 < notes["dispatch_idle_named"] <= 1
    assert notes["device_attributed"] is None  # no device operation
    assert notes["counters"]["query.batches"] == notes["batches"] \
        == notes["span_batches"] > 0
    assert notes["counters"]["query.queries"] == res["attempted"]
    assert set(notes["stage_phases_s"]) == {
        "stage.page_of", "stage.small_tables", "stage.copies"}
    sm = res["span_metrics"]
    assert sm["compile_ms"] > 0 and sm["launch_ms"] > 0
    assert "query.dispatch" in sm["host_s"]
    assert "compile_miss_pct" in res["metrics"]
