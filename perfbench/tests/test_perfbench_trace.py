"""The trace's arithmetic on made-up intervals: busy time as a union, the
launching thread's share, and the breakdown's top entries."""

from perfbench.harness.trace import Trace


def make():
    device = [(0.0, 1.0, "k2", "main"), (0.5, 1.5, "conv", "other"), (2.0, 2.5, "k2", "main"),
              (3.0, 3.25, "copy", "other")]
    host = [(1.5, 2.0, "cudaStreamSynchronize", 7), (0.0, 4.0, "outer", 7), (2.5, 3.0, "elsewhere", 9)]
    return Trace(4.0, device, host, 7)


def test_busy_is_the_union():
    t = make()
    assert t.busy_s() == 2.25
    assert t.busy_s(launcher="main") == 1.5
    assert t.busy_s(launcher="other") == 1.25
    assert t.time_s("k2") == 1.5


def test_breakdown_names_ops_and_gaps():
    b = make().breakdown()
    assert b["device_ops"][0] == ["k2", 1.5]
    gaps = dict((round(s, 3), n) for n, s in b["idle_gaps"])
    assert gaps[0.75] == "outer"  # 3.25-4.0: only the outer call on the driving thread
    assert gaps[0.5] in ("cudaStreamSynchronize", "outer")
    bare = Trace(1.0, [(0.0, 0.25, "k", "main")], [(0.5, 0.9, "prepare", 9)], 7)
    assert bare.breakdown()["idle_gaps"] == [["another thread: prepare", 0.75]]
    assert len(b["idle_gaps"]) == 3
