"""The reduction of a profiler trace (``mdbench/trace.py``) on a
hand-checked set of events."""

import pytest

from mdbench import trace


def test_reduce_events_by_hand():
    us = 1e-6
    evs = [(True, "k1", 0.0, 10.0), (True, "k2", 5.0, 12.0),
           (True, "k3", 20.0, 30.0), (True, "k1", 40.0, 50.0),
           (False, "cudaGraphLaunch", 11.0, 21.0),
           (False, trace.PROFILER_EVENT, 31.0, 45.0)]
    res = trace.reduce_events(evs, 60 * us)
    assert res["wall_s"] == 60 * us
    # busy: [0, 12], [20, 30], [40, 50]
    assert res["busy_s"] == pytest.approx(32 * us)
    assert [n for n, _ in res["device_ops"]] == ["k1", "k3", "k2"]
    assert res["device_ops"][0][1] == pytest.approx(20 * us)
    # the gap from 30 began with no host event running, the one from 12
    # in the graph launch
    assert [n for n, _ in res["idle_gaps"]] == ["no host event",
                                                "cudaGraphLaunch"]
    assert [g for _, g in res["idle_gaps"]] == pytest.approx([10 * us,
                                                              8 * us])
    # the buffer request [31, 45] overlaps the busy [40, 45]
    assert res["profiler_idle_s"] == pytest.approx(9 * us)


def test_reduce_events_without_device_events():
    res = trace.reduce_events([(False, "cudaGraphLaunch", 0.0, 5.0)], 1.0)
    assert res["busy_s"] is None and res["idle_gaps"] == []
