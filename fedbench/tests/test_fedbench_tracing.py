"""The trace reader and the compared numbers on hand-made readings."""
from __future__ import annotations

import math

import pytest
import torch

from fedbench import check
from fedbench.tracing import DeviceOp, HostSpan, Trace


def _trace():
    # two kernels launched inside a backward node on thread 2, one
    # outside it on thread 1; the device idles from 30 to 50 ns while the
    # host runs "aten::item"
    ops = [DeviceOp("gemm_a", 10, 20, 1), DeviceOp("ssd_scan_kernel", 20,
                                                   30, 2),
           DeviceOp("gemm_b", 50, 60, 3)]
    launches = {1: (2, 5), 2: (2, 8), 3: (1, 45)}
    spans = [HostSpan("fedbench.window", 0, 60, 1),
             HostSpan("autograd::engine::evaluate_function: "
                      "Mamba2ScanBackward0", 4, 9, 2),
             HostSpan("aten::item", 31, 49, 1)]
    return Trace(ops, launches, spans, (0, 60))


def test_kernel_time_and_launches_by_name():
    tr = _trace()
    assert tr.kernel_time("gemm") == (20e-9, 2)
    assert tr.kernel_time("ssd_scan_kernel") == (10e-9, 1)


def test_device_time_under_a_host_span_of_the_launching_thread():
    assert _trace().time_under("Mamba2ScanBackward") == (20e-9, 2)
    assert _trace().time_under("ChunkedCrossEntropyBackward") == (0.0, 0)


def test_busy_idle_and_what_the_host_did():
    tr = _trace()
    assert tr.busy_s() == pytest.approx(30e-9)
    assert tr.window_s() == pytest.approx(60e-9)
    gaps = dict((k, v) for k, v in tr.idle_gaps())
    assert gaps["aten::item"] == pytest.approx(20e-9)
    assert tr.top_device_ops(1) == [["gemm_a", 10e-9]]


def _side(losses, n1, n3, d1=None, d3=None):
    """Readings of a side whose leaves each hold one number: the change
    ``d`` (its norm by default)."""
    def deltas(n, d):
        return {k: torch.tensor([(d or n)[k]]) for k in n}
    return {"losses": losses, "norms": {0: n1, 2: n3},
            "deltas": {0: deltas(n1, d1), 2: deltas(n3, d3)}}


def test_numbers_take_the_worst_or_the_median_leaf():
    ref = _side({(0, 0, 0): 2.0, (2, 0, 0): 2.0},
                {"a": 1.0, "b": 1.0, "c": 1.0}, {"a": 1.0, "b": 1.0,
                                                 "c": 1.0})
    prog = _side({(0, 0, 0): 2.0, (2, 0, 0): 2.2},
                 {"a": 1.0, "b": 1.1, "c": 1.3}, {"a": 1.0, "b": 1.0,
                                                  "c": 1.0})
    nums = check.numbers(prog, ref, 0, 2)
    assert set(nums) == set(check.NAMES)
    assert nums["loss"] == pytest.approx(0.1)
    assert nums["step1"] == pytest.approx(0.3)
    assert nums["step1_diff"] == pytest.approx(0.3)
    assert nums["step1_median"] == pytest.approx(0.1)
    assert nums["step1_diff_median"] == pytest.approx(0.1)
    assert nums["change"] == nums["change_diff_median"] == 0.0
    assert check.numbers(prog, ref, 0, 2, loss_rounds=1)["loss"] == 0.0


def test_numbers_leave_out_quiet_leaves_and_fail_missing_ones():
    ref = _side({(0, 0, 0): 1.0}, {"a": 1.0, "b": 1.0, "q": 1e-9},
                {"a": 1.0, "b": 1.0, "q": 1e-9})
    prog = _side({(0, 0, 0): 1.0}, {"a": 1.0, "b": 1.0, "q": 0.0},
                 {"a": 1.0, "b": 1.0, "q": 1.0})
    nums = check.numbers(prog, ref, 0, 2)
    assert nums["change"] == nums["change_diff"] == 0.0
    prog["losses"] = {}
    assert math.isinf(check.numbers(prog, ref, 0, 2)["loss"])
    del prog["deltas"][0]["a"]
    assert math.isinf(check.numbers(prog, ref, 0, 2)["step1_diff"])
    ok, table = check.judge(dict.fromkeys(check.NAMES, 0.0) | {"step1": 2.0},
                            dict.fromkeys(check.NAMES, 1.0))
    assert not ok and table["step1"] == {"value": 2.0, "limit": 1.0}
    # a number the cell gives no limit is not compared
    some = ("loss", "step1_median", "change")
    ok, table = check.judge(dict.fromkeys(check.NAMES, 2.0)
                            | dict.fromkeys(some, 0.0),
                            dict.fromkeys(some, 1.0))
    assert ok and set(table) == set(some)


def test_a_change_of_the_right_size_in_a_wrong_direction_fails():
    """A leaf whose change has the reference's norm and the wrong sign
    passes the gaps of norms and fails the norms of differences."""
    n = {"a": 1.0, "b": 1.0, "c": 1.0}
    ref = _side({(0, 0, 0): 1.0}, n, n)
    prog = _side({(0, 0, 0): 1.0}, n, n, d1={**n, "b": -1.0},
                 d3={**n, "c": -1.0})
    nums = check.numbers(prog, ref, 0, 2)
    assert nums["step1"] == nums["change"] == 0.0
    assert nums["step1_diff"] == nums["change_diff"] == pytest.approx(2.0)
