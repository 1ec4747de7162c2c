"""The reduction of a profiler trace to busy time, top operations and idle
gaps, on a hand-made trace."""

import pytest

from bench_port import trace


def ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_union_ops_and_gaps():
    events = [
        ev("kernel", "spmv", 0, 10, 1), ev("kernel", "axpy", 5, 10, 2),  # overlap: busy 0-15
        ev("gpu_memcpy", "copy", 40, 5, 3),  # busy 40-45; gap 15-40 (25 us)
        ev("kernel", "spmv", 100, 20, 4),  # gap 45-100 (55 us)
        ev("cpu_op", "aten::index_select", -3, 2), ev("cuda_runtime", "launch", -2, 1, 1),
        ev("cuda_runtime", "launch", -1, 1, 2),  # launched outside any op
        ev("cpu_op", "aten::copy_", 36, 3), ev("cuda_runtime", "launch", 37, 1, 3),
        ev("cpu_op", "aten::index_select", 90, 5), ev("cuda_runtime", "launch", 91, 1, 4),
        ev("cpu_op", "aten::item", 10, 35),  # covers the first gap's middle, 27.5
        ev("cpu_op", "aten::_local_scalar_dense", 12, 20),  # inner, ends at 32 (after 27.5)
        ev("cpu_op", "aten::randperm", 50, 10),  # ends before the second gap's middle, 72.5
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 0},  # no duration: ignored
    ]
    busy, ops, gaps = trace.reduce_events(events)
    assert busy == 15 + 5 + 20
    assert ops == [["aten::index_select: spmv", pytest.approx(30e-6)],
                   ["?: axpy", pytest.approx(10e-6)], ["aten::copy_: copy", pytest.approx(5e-6)]]
    assert gaps == [["host python", pytest.approx(55e-6)],
                    ["aten::_local_scalar_dense", pytest.approx(25e-6)]]


def test_no_device_events():
    assert trace.reduce_events([ev("cpu_op", "aten::add", 0, 1)]) == (0, [], [])
