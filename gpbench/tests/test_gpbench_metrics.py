"""Each metric reader on a synthetic run record."""

import numpy as np
import pytest

from gpbench import flops, peaks, run


def record(mode="fit", model="GPRModel", traced=True):
    """Two days (mode "fit") or two passes (mode "repredict") of three
    experts each."""
    units = []
    for k in range(2):
        u = {"kind": "day" if mode == "fit" else "pass",
             "experts": 3, "points": 30,
             "n": np.array([100, 200, 300]), "p": np.array([10, 10, 10]),
             "iterations": np.array([5, 6, 7]) if mode == "fit"
             else np.zeros(3, int),
             "buckets": [{"seconds": 1.0, "engine_seconds": 0.9,
                          "pool_iterations": 40},
                         {"seconds": 2.0, "engine_seconds": 2.0,
                          "pool_iterations": 0}]}
        if mode != "fit":
            u["smooth_s"] = 0.01 * (k + 1)
        units.append(u)
    tr = {"busy_s": 3.0, "window_s": 4.0,
          "launches": {"vg": 0.5, "predict": 0.25}} if traced else None
    return {"model": model, "D": 3, "M": 300, "units": units,
            "window_s": 6.0, "setup_s": 12.5, "trace": tr}


def read(name, rec):
    return run.metric_reader(name)(rec, name)


def test_end_to_end():
    assert read("experts_per_s", record()) == pytest.approx(6 / 6.0)
    assert read("experts_per_s", record("repredict")) is None
    assert read("pred_points_per_s", record("repredict")) == \
        pytest.approx(60 / 6.0)
    assert read("pred_points_per_s", record()) is None
    assert read("setup_s", record()) == 12.5


def test_level_wait_and_pool_iters_and_smooth_ms():
    assert read("level_wait.fit", record()) == pytest.approx(
        100 * 0.2 / 6.0)
    assert read("level_wait.repredict", record("repredict")) == \
        pytest.approx(100 * 0.2 / 6.0)
    assert read("pool_iters", record()) == 40
    assert read("pool_iters", record("repredict")) is None
    assert read("smooth_ms", record("repredict")) == pytest.approx(15.0)
    assert read("smooth_ms", record()) is None


def test_device_shares():
    rec = record()
    vg = 2 * sum(i * flops.gpr_vg(n, 3) for n, i in
                 zip((100, 200, 300), (5, 6, 7)))
    pred = 2 * sum(flops.gpr_predict(n, 10, 3) for n in (100, 200, 300))
    assert read("vg_roofline", rec) == pytest.approx(
        100 * vg / peaks.FP32_FLOPS / 0.5)
    assert read("predict_roofline", rec) == pytest.approx(
        100 * pred / peaks.FP32_FLOPS / 0.25)
    assert read("device_idle.fit", rec) == pytest.approx(25.0)
    assert read("mfu.fit", rec) == pytest.approx(
        100 * (vg + pred) / (6.0 * peaks.FP32_FLOPS))
    assert read("mfu.repredict", record("repredict")) == pytest.approx(
        100 * pred / (6.0 * peaks.FP32_FLOPS))


@pytest.mark.parametrize("name", ["vg_roofline", "predict_roofline",
                                  "device_idle.fit"])
def test_nothing_to_read_gives_nothing(name):
    assert read(name, record(traced=False)) is None
    rec = record(model="SGPRModel")
    if "roofline" in name:
        assert read(name, rec) is None
