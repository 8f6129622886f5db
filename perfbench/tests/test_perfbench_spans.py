"""The five readers of the card's idle time inside the program's spans, on a
made-up trace: their values, the driving thread alone, the serving four as
disjoint parts of the idle share, and None where there is nothing to read."""

import numpy as np
import pytest

from perfbench.harness import spans
from perfbench.harness.context import Run, Served
from perfbench.harness.spec import Spec
from perfbench.harness.trace import Trace

SERVE = ("idle_wait_dispatch_pct.serve", "idle_decode_host_pct.serve", "idle_drain_pct.serve",
         "idle_between_requests_pct.serve")
MAIN, OTHER = 7, 9


def serve_trace():
    """10 s, the card busy 4 s of it; two requests on the driving thread, and
    spans of the same names on another thread, which no reader counts."""
    device = [(1.0, 2.0, "k2", "main"), (4.0, 6.0, "conv", "other"), (8.0, 9.0, "k2", "main")]
    host = [(0.5, 5.0, "khmer_ocr.predict", MAIN), (6.0, 9.5, "khmer_ocr.predict", MAIN),
            (0.5, 1.5, "khmer_ocr.wait_dispatch", MAIN), (1.5, 3.0, "khmer_ocr.decode", MAIN),
            (2.0, 2.5, "khmer_ocr.decode.exit_test", MAIN), (3.0, 4.5, "khmer_ocr.drain", MAIN),
            (6.0, 7.0, "khmer_ocr.wait_dispatch", MAIN), (7.0, 8.5, "khmer_ocr.decode", MAIN),
            (8.5, 9.5, "khmer_ocr.drain", MAIN), (4.5, 5.0, "khmer_ocr.join", MAIN),
            (0.0, 10.0, "khmer_ocr.wait_dispatch", OTHER), (5.0, 6.0, "khmer_ocr.drain", OTHER),
            (0.0, 10.0, "khmer_ocr.predict", OTHER)]
    return Trace(10.0, device, host, MAIN)


def served(trace):
    return Run({}, {}, 1.0, 10.0, served=[Served(2, [2, 3], [5, 6], 0.1)], trace=trace)


def read(root, name, run):
    return Spec(root).reader(name)(run)


@pytest.mark.parametrize("name, value", [
    ("idle_wait_dispatch_pct.serve", 15.0),  # idle 0.5-1.0 and 6.0-7.0
    ("idle_decode_host_pct.serve", 20.0),  # 2.0-3.0 and 7.0-8.0; the exit test's own span is not the decode's
    ("idle_drain_pct.serve", 15.0),  # 3.0-4.0 and 9.0-9.5
    ("idle_between_requests_pct.serve", 10.0),  # 0.0-0.5 and 9.5-10.0; 5.0-6.0 is busy
])
def test_serving_values(root, name, value):
    assert read(root, name, served(serve_trace())) == value


def test_training_value(root):
    trace = Trace(4.0, [(0.0, 3.0, "dgrad", "main")],
                  [(2.5, 3.5, "khmer_ocr.train.wait_batch", MAIN), (3.5, 3.75, "khmer_ocr.train.wait_batch", MAIN),
                   (0.0, 4.0, "khmer_ocr.train.wait_batch", OTHER), (0.0, 0.5, "khmer_ocr.train.step", MAIN)], MAIN)
    run = Run({}, {}, 1.0, 4.0, samples=64, trace=trace)
    assert read(root, "idle_wait_batch_pct.train", run) == 18.75


@pytest.mark.parametrize("name", SERVE)
def test_another_threads_spans_are_ignored(root, name):
    """The other thread's spans cover the whole window: dropping them changes nothing."""
    t = serve_trace()
    alone = Trace(t.window_s, t.device, [h for h in t.host if h[3] == MAIN], MAIN)
    assert read(root, name, served(t)) == read(root, name, served(alone))
    only_other = Trace(t.window_s, t.device, [h for h in t.host if h[3] == OTHER], MAIN)
    assert read(root, name, served(only_other)) is None


def random_trace(rng):
    """Device intervals at random; requests at random, each a run of the
    caller's spans in turn with gaps between them."""
    w = 5.0
    device = []
    for s in np.sort(rng.uniform(0, w, 40)):
        device.append((float(s), float(s + rng.uniform(0, 0.2)), "k", "main"))
    host, at = [], float(rng.uniform(0, 0.1))
    while at < w:
        start = at
        for name in ("khmer_ocr.wait_dispatch", "khmer_ocr.decode", "khmer_ocr.drain") * int(rng.integers(1, 4)):
            at += float(rng.uniform(0, 0.05))
            end = at + float(rng.uniform(0, 0.1))
            host.append((at, end, name, MAIN))
            at = end
        at += float(rng.uniform(0, 0.02))
        host.append((start, at, "khmer_ocr.predict", MAIN))
        at += float(rng.uniform(0, 0.05))
    return Trace(w, device, host, MAIN)


@pytest.mark.parametrize("seed", range(8))
def test_serving_four_never_sum_above_the_idle_share(root, seed):
    run = served(random_trace(np.random.default_rng(seed)))
    parts = [read(root, n, run) for n in SERVE]
    idle = read(root, "device_idle_pct.serve", run)
    assert all(p is not None and p >= 0 for p in parts)
    assert sum(parts) <= idle + 1e-9


@pytest.mark.parametrize("name", SERVE + ("idle_wait_batch_pct.train",))
def test_none_without_a_trace_or_work(root, name):
    t = serve_trace()
    assert read(root, name, Run({}, {}, 1.0, 10.0, served=[Served(2, [2, 3], [5, 6], 0.1)])) is None
    assert read(root, name, Run({}, {}, 1.0, 10.0, trace=t)) is None  # served nothing, trained nothing


@pytest.mark.parametrize("name", SERVE + ("idle_wait_batch_pct.train",))
def test_none_where_the_program_records_no_span(root, name):
    """The parent of the spans: a trace with the device's work and no span of the program's."""
    t = Trace(10.0, [(1.0, 2.0, "k2", "main")], [(0.0, 0.5, "cudaLaunchKernel", MAIN)], MAIN)
    run = Run({}, {}, 1.0, 10.0, served=[Served(2, [2, 3], [5, 6], 0.1)], samples=64, trace=t)
    assert read(root, name, run) is None


def test_interval_arithmetic():
    assert spans.merged([(3.0, 4.0), (-1.0, 1.0), (0.5, 2.0), (9.0, 12.0), (5.0, 5.0)], 10.0) == \
        [(0.0, 2.0), (3.0, 4.0), (9.0, 10.0)]
    assert spans.complement([(0.0, 2.0), (3.0, 4.0)], 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    assert spans.complement([], 5.0) == [(0.0, 5.0)]
    assert spans.overlap_s([(0.0, 2.0), (3.0, 4.0)], [(1.0, 3.5)]) == 1.5
