"""The readers of the SGPR cell's program counter and span (cholinv_roofline,
sgpr_vg_issue_ms) on a synthetic span store, and the cell itself at a tiny
size on the CPU through route hybrid's plain path."""

import sys

import pytest

from gpbench import cholinv_flops, peaks, run
from gpsat_tpu_torch import tracing

from conftest import tiny_run, tiny_spec


def span(name, t0, t1, mats=0):
    return {"id": 0, "name": name, "t0": t0, "t1": t1, "parent": None,
            "thread": 1, "attrs": {},
            "counts": {"cholinv_mats": mats} if mats else {}}


# a window from 10.0 to 20.0 s, and records on either side
STORE = [
    span("sgpr.vg", 9.0, 9.5, mats=8),                # before the window
    span("sgpr.vg", 10.0, 10.004, mats=2),
    span("lbfgs.issue", 10.0, 10.01),
    span("sgpr.vg", 12.0, 12.008, mats=2),
    span("sgpr.predict", 15.0, 15.5, mats=6),
    {"id": 0, "name": None, "t0": 16.0, "t1": 16.0, "parent": None,
     "thread": 1, "attrs": {}, "counts": {"cholinv_mats": 3}},
    span("sgpr.vg", 20.0, 21.0, mats=50),             # at the window's end
]
KERNELS = {"gp_cholinv_diag_kernel": 0.25, "gp_cholinv_update_kernel": 0.5,
           "gp_vg_grad_kernel": 7.0, "cutlass::Kernel2": 3.0}


def record(model="SGPRModel", traced=True, t=(10.0, 20.0)):
    units = [{"kind": "day", "t0": t[0], "t1": (t[0] + t[1]) / 2},
             {"kind": "day", "t0": (t[0] + t[1]) / 2, "t1": t[1]}]
    tr = {"busy_s": 5.0, "window_s": 10.0, "kernels": dict(KERNELS),
          "launches": {}, "idle": {}} if traced else None
    return {"model": model, "D": 3, "M": 300, "units": units, "trace": tr}


def read(name, rec):
    return run.metric_reader(name)(rec, name)


@pytest.fixture
def store(monkeypatch):
    monkeypatch.setattr(tracing, "snapshot", lambda: list(STORE))


def test_cholinv_roofline_is_the_windows_factors_over_their_kernels(store):
    useful = (2 + 2 + 6 + 3) * cholinv_flops.factor_and_invert(300)
    assert read("cholinv_roofline", record()) == pytest.approx(
        100 * useful / peaks.FP32_FLOPS / 0.75)


def test_factor_and_invert_counts_both_halves():
    assert cholinv_flops.factor_and_invert(300) == pytest.approx(1.8e7)
    assert cholinv_flops.factor_and_invert(512) == pytest.approx(
        2 * 512 ** 3 / 3)


def test_sgpr_vg_issue_ms_is_the_mean_span_of_the_window(store):
    assert read("sgpr_vg_issue_ms", record()) == pytest.approx(6.0)
    rec = record(t=(11.0, 20.0))
    assert read("sgpr_vg_issue_ms", rec) == pytest.approx(8.0)


def test_nothing_to_read_gives_nothing(store, monkeypatch):
    # exact GPR launches the gp_cholinv_* kernels inside vg and predict
    assert read("cholinv_roofline", record(model="GPRModel")) is None
    assert read("cholinv_roofline", record(traced=False)) is None
    no_kernels = record()
    no_kernels["trace"]["kernels"] = {"gp_vg_grad_kernel": 1.0}
    assert read("cholinv_roofline", no_kernels) is None
    empty = record(t=(30.0, 40.0))
    assert read("cholinv_roofline", empty) is None
    assert read("sgpr_vg_issue_ms", empty) is None
    no_units = dict(record(), units=[])
    assert read("cholinv_roofline", no_units) is None
    assert read("sgpr_vg_issue_ms", no_units) is None


def test_a_program_without_the_spans_gives_nothing(monkeypatch):
    """The parent of the change that adds the span and the counter: its
    records hold neither, and a program without the recorder at all."""
    monkeypatch.setattr(tracing, "snapshot", lambda: [
        span("lbfgs.issue", 10.0, 10.01), span("execute.level", 10.0, 15.0)])
    for name in ("cholinv_roofline", "sgpr_vg_issue_ms"):
        assert read(name, record()) is None
    monkeypatch.setitem(sys.modules, "gpsat_tpu_torch.tracing", None)
    monkeypatch.delattr(sys.modules["gpsat_tpu_torch"], "tracing")
    for name in ("cholinv_roofline", "sgpr_vg_issue_ms"):
        assert read(name, record()) is None


def test_the_uncut_cell_reads_its_metrics_from_the_program(monkeypatch):
    """sgpr_is2_full.fit at a tiny size on route hybrid's plain path (the
    card's path, with the plain cholinv): a run under the recorder gives
    both readers something to read, with a stand-in trace of the cholinv
    kernels; the cell's entries reach its configuration, limits and
    metrics."""
    from gpsat_tpu_torch.ops import cuda_gpr
    monkeypatch.setattr(cuda_gpr, "_FORCE_KERNEL_PATH", True)
    spec = tiny_spec("sgpr_is2_full.fit")
    assert spec["config"]["deployment"]["expert_stride"] == 1
    assert spec["config"]["reduced"] == {}
    assert spec["model"].MAXIMISED
    per_layer = {m["name"] for m in spec["metrics"]["per_layer"]}
    assert {"cholinv_roofline", "sgpr_vg_issue_ms", "pool_iters",
            "host_reads.fit", "mfu.fit"} <= per_layer
    assert not {"vg_roofline", "graph_replays.fit"} & per_layer
    assert [m["name"] for m in spec["metrics"]["end_to_end"]] == \
        ["experts_per_s", "setup_s"]
    tracing.clear()
    with tracing.enable():
        rec = tiny_run("sgpr_is2_full.fit", spec=spec)
    rec["trace"] = {"busy_s": 1.0, "window_s": 2.0, "launches": {},
                    "idle": {}, "kernels": {"gp_cholinv_diag_kernel": 1.0}}
    line = run.result_line(spec, rec, True)
    tracing.clear()
    assert line["metrics"]["sgpr_vg_issue_ms"]["value"] > 0
    assert line["metrics"]["cholinv_roofline"]["value"] > 0
