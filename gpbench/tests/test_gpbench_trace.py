"""The trace's reduction on synthetic device events."""

import pytest

from gpbench import trace


def test_launches_are_told_apart_by_their_finish_kernel():
    ev = [("void gp_gpr_scale_kernel<3>(float*)", 0, 1),
          ("gp_cholinv_diag_kernel<CiKernel<1> >", 1, 3),
          ("gp_vg_finish_kernel", 3, 4),
          ("at::native::vectorized_elementwise_kernel", 5, 6),
          ("gp_gpr_scale_kernel", 7, 8), ("gp_gpr_scale_kernel", 8, 9),
          ("gp_cholinv_border_kernel", 9, 12),
          ("gp_predict_finish_kernel", 12, 13),
          ("gp_cholinv_diag_kernel", 14, 15),
          ("at::native::reduce_kernel", 15, 16)]
    got = trace.launch_seconds(ev)
    assert got == {"vg": pytest.approx(4e-6), "predict": pytest.approx(6e-6),
                   "other": pytest.approx(1e-6)}


def test_busy_time_and_idle_gaps_by_span():
    ev = [("marker", 100.0, 101.0), ("k", 200.0, 300.0),
          ("k", 250.0, 400.0), ("k", 900.0, 1000.0)]
    # host clock: the window opens at 10.0 s and lasts 1000 us
    spans = [("level N=64", 10.0, 10.0005), ("level N=128", 10.0005, 10.001)]
    s = trace.reduce(ev, 10.0, 10.001, spans)
    assert s["busy_s"] == pytest.approx((1 + 200 + 100) * 1e-6)
    assert s["window_s"] == pytest.approx(1e-3)
    # gaps 101-200, 400-900 and 1000-1100: midpoints 50.5, 550 and 950 us
    # after the marker's start
    assert s["idle"]["level N=64"] == pytest.approx(99e-6)
    assert s["idle"]["level N=128"] == pytest.approx(600e-6)
    b = trace.breakdown(s)
    assert b["device_ops"][0][0] == "k" and len(b["idle_gaps"]) == 2
