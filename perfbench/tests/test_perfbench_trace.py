"""The trace's arithmetic on a made-up profile: the union of device
intervals, kernels apart from copies, idle gaps labelled by the harness
span the host was in, and the per-layer readers over it."""

import numpy as np

from perfbench import harness, trace, work


class Ev:
    def __init__(self, name, dev, s, t, annotation=False, card=0):
        self._n, self._d, self._s, self._t = name, dev, s, t
        self._a, self._card = annotation, card

    def name(self):
        return self._n

    def device_type(self):
        return f"DeviceType.{self._d}"

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._t

    def device_index(self):
        return self._card

    def is_user_annotation(self):
        return self._a


class Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type(
            "K", (), {"events": lambda _self: events})()


EVENTS = [
    # host spans: dispatch 0-100, finish 100-150, between 150-160,
    # dispatch 160-300
    Ev("bench.dispatch", "CPU", 0, 100, True),
    Ev("bench.finish", "CPU", 100, 150, True),
    Ev("bench.between", "CPU", 150, 160, True),
    Ev("bench.dispatch", "CPU", 160, 300, True),
    # the same spans as the device sees them: not device work
    Ev("bench.dispatch", "CUDA", 0, 300, True),
    # device work: two overlapping kernels, a copy, a late kernel past
    # the window's end (cut at 300)
    Ev("void (anonymous namespace)::k_a<1>(int*)", "CUDA", 10, 60),
    Ev("void (anonymous namespace)::k_b(int*)", "CUDA", 40, 80),
    Ev("Memcpy DtoH (Device -> Pinned)", "CUDA", 120, 140),
    Ev("void (anonymous namespace)::k_a<1>(int*)", "CUDA", 250, 400),
    Ev("aten::add", "CPU", 5, 9),
]


def test_union_busy_and_gaps():
    tr = trace.read(Prof(EVENTS))
    assert np.isclose(tr.window_s, 300e-9)
    # busy: [10, 80], [120, 140], [250, 300]
    assert np.isclose(tr.busy_s, (70 + 20 + 50) * 1e-9)
    assert np.isclose(tr.kernel_busy_s, (70 + 50) * 1e-9)
    # idle: [0, 10] and [80, 100] in dispatch, [100, 120] and [140, 150]
    # in finish, [150, 160] in between, [160, 250] in dispatch
    assert np.isclose(tr.idle["bench.dispatch"], (10 + 20 + 90) * 1e-9)
    assert np.isclose(tr.idle["bench.finish"], 30e-9)
    assert np.isclose(tr.idle["bench.between"], 10e-9)
    # the gaps: [140, 250] (finish 10, between 10, dispatch 90), [80, 120]
    # (dispatch 20, finish 20, named by the first), [0, 10]
    assert [g[0] for g in tr.gaps] == ["bench.dispatch"] * 3
    assert np.allclose([g[1] for g in tr.gaps], [110e-9, 40e-9, 10e-9])
    ops = dict(tr.ops)
    assert np.isclose(ops["k_a<1>"], (50 + 50) * 1e-9)
    assert np.isclose(ops["Memcpy DtoH "], 20e-9)
    bd = trace.breakdown(tr)
    assert bd["device_ops"][0][0] == "k_a<1>"
    assert bd["idle_gaps"][0][0] == "idle in bench.dispatch"
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


def test_readers_over_a_trace():
    tr = trace.read(Prof(EVENTS))
    run = harness.Run(setup_s=1.0, build_s=0.5, stage_s=0.2,
                      index_bytes=2**30, batches=[], window_s=1.0,
                      peak_bytes=2**31, bytes_moved=int(3.35e12 * 60e-9),
                      trace=tr, peaks=work.peaks(), device="cuda")
    assert np.isclose(harness.reader("query_roofline_pct")(run), 50.0)
    assert np.isclose(harness.reader("device_idle_pct")(run),
                      100 * (1 - 140 / 300))
    assert harness.reader("index_gib")(run) == 1.0
    assert harness.reader("device_peak_gib")(run) == 2.0
    assert harness.reader("dispatch_ms")(run) is None
    run.trace = None
    assert harness.reader("query_roofline_pct")(run) is None


def test_batch_bytes():
    post = np.array([10, 0, 5])
    assert work.batch_bytes(post, 7, 4, 8) == (
        4 * 15 + 3 * work.answer_bytes(4, 8) + 4 * 7)
    assert work.answer_bytes(64, 1024) == 4 * (5 * 64 + 2 + 1024)
    grid = np.array([[[1, -1], [2, 3]]])
    counts = np.array([0, 10, 20, 30])
    assert work.query_postings(grid, counts).tolist() == [60]
