"""The port's span and counter recorder (gpsat_tpu_torch.tracing) and the
spans that execute_buckets, the engines and the L-BFGS pool record, on the
CPU."""

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from gpsat_tpu_torch import tracing
from gpsat_tpu_torch.local_experts import execute_buckets, make_engine
from gpsat_tpu_torch.models.exact_gpr import GPRModel
from gpsat_tpu_torch.parallel import scheduler


@pytest.fixture(autouse=True)
def _empty():
    tracing.clear()
    yield
    tracing.clear()


def by_name(records, name):
    return [r for r in records if r["name"] == name]


def test_spans_nest_with_their_parent_and_thread():
    def apart():
        with tracing.span("apart"):
            pass

    with tracing.enable(), ThreadPoolExecutor(1) as ex:
        with tracing.span("outer", k=1):
            with tracing.span("inner"):
                ex.submit(apart).result()
            with tracing.span("inner"):
                with tracing.span("leaf"):
                    pass
    recs = tracing.snapshot()
    outer, = by_name(recs, "outer")
    inner = by_name(recs, "inner")
    leaf, = by_name(recs, "leaf")
    me = threading.get_ident()
    assert outer["parent"] is None and outer["attrs"] == {"k": 1}
    assert [r["parent"] for r in inner] == [outer["id"]] * 2
    assert leaf["parent"] == inner[1]["id"]
    assert {r["thread"] for r in (outer, leaf, *inner)} == {me}
    assert outer["t0"] <= inner[0]["t0"] <= inner[0]["t1"] <= \
        inner[1]["t0"] <= leaf["t0"] <= leaf["t1"] <= inner[1]["t1"] <= \
        outer["t1"]
    # each thread nests its own spans
    other, = by_name(recs, "apart")
    assert other["parent"] is None and other["thread"] != me
    # innermost first: the first interval holding the leaf's time is the leaf
    ivs = tracing.intervals(recs, thread=me)
    mid = (leaf["t0"] + leaf["t1"]) / 2
    assert next(n for n, a, b in ivs if a <= mid <= b) == "leaf"
    assert [n for n, _, _ in ivs].index("outer") == len(ivs) - 1


def test_counts_go_to_the_innermost_open_span():
    with tracing.enable():
        tracing.count("reads")
        with tracing.span("outer"):
            tracing.count("reads", 2)
            with tracing.span("inner"):
                tracing.count("reads")
                tracing.count("reads", 3)
                tracing.count("other")
            tracing.count("reads")
    recs = tracing.snapshot()
    loose, = [r for r in recs if r["name"] is None]
    assert loose["counts"] == {"reads": 1} and loose["t0"] == loose["t1"]
    assert by_name(recs, "outer")[0]["counts"] == {"reads": 3}
    assert by_name(recs, "inner")[0]["counts"] == {"reads": 4, "other": 1}


def test_nothing_is_recorded_when_off():
    assert not tracing.enabled()
    a, b = tracing.span("x"), tracing.span("y", n=3)
    assert a is b
    with a:
        tracing.count("reads")
    t = torch.ones(3)
    assert tracing.host(t) is t
    assert tracing.propagate(len) is len
    assert tracing.snapshot() == []
    with tracing.enable():
        assert tracing.enabled()
    assert not tracing.enabled()


def test_a_cpu_profiler_turns_recording_on():
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts):
        assert tracing.enabled()
        with tracing.span("profiled"):
            tracing.count("reads")
        with ThreadPoolExecutor(1) as ex:
            # the profiler collects in this thread only: work handed to
            # another thread records there through propagate
            assert not ex.submit(tracing.enabled).result()
            assert ex.submit(tracing.propagate(tracing.enabled)).result()
    assert not tracing.enabled()
    rec, = tracing.snapshot()
    assert rec["name"] == "profiled" and rec["counts"] == {"reads": 1}


def tiny_levels(E=30, seed=3):
    """Raw per-expert arrays over the 16 and 32 levels, each with
    prediction locations."""
    rng = np.random.default_rng(seed)
    X_list, obs_list, pred_list = [], [], []
    for i in range(E):
        n = int(rng.integers(9, 30))
        X = rng.uniform(-50.0, 50.0, (n, 2))
        X_list.append(X)
        obs_list.append(np.sin(X[:, 0] / 20.0) + 0.1 * rng.standard_normal(n))
        pred_list.append(rng.uniform(-50.0, 50.0, (5, 2)))
    return X_list, obs_list, pred_list


def small_engine():
    return make_engine(GPRModel, {"coords_scale": [10.0, 10.0]},
                       {"lengthscales": {"low": [1e-3, 1e-3],
                                         "high": [50.0, 50.0]},
                        "likelihood_variance": {"low": 1e-4, "high": 1.0}},
                       coords_dim=2, optim_kwargs={"max_iter": 40},
                       device="cpu")


def ancestors(rec, by_id):
    out = []
    while rec["parent"] is not None:
        rec = by_id[rec["parent"]]
        out.append(rec)
    return out


@pytest.mark.parametrize("slots", [4, None])
def test_execute_buckets_records_each_level_and_pool_iteration(monkeypatch,
                                                               slots):
    """Slots 4: every level runs the L-BFGS pool, then the fill; no slot
    limit: every level fits in one chunk, the chunked path."""
    if slots is not None:
        monkeypatch.setattr(scheduler, "auto_batch_size",
                            lambda *a, **k: slots)
    X_list, obs_list, pred_list = tiny_levels()
    with tracing.enable():
        out = execute_buckets(small_engine(), X_list, obs_list, pred_list,
                              coords_scale=[[10.0, 10.0]], obs_mean="local")
    recs = tracing.snapshot()
    by_id = {r["id"]: r for r in recs}
    me = threading.get_ident()
    levels = by_name(recs, "execute.level")
    assert [(r["attrs"]["n_max"], r["attrs"]["experts"]) for r in levels] \
        == [(b["n_max"], b["experts"]) for b in out["buckets"]]
    assert len(levels) >= 2
    asm = by_name(recs, "execute.assemble")
    assert [r["attrs"]["n_max"] for r in asm] == \
        [b["n_max"] for b in out["buckets"]]
    assert all(r["thread"] != me and r["parent"] is None for r in asm)
    for lv, b in zip(levels, out["buckets"]):
        inside = [r for r in recs if lv in ancestors(r, by_id)]
        names = {r["name"] for r in inside}
        assert {"execute.assemble_wait", "execute.scatter"} <= names
        pools = by_name(inside, "engine.pool")
        if slots is None:
            assert not pools and b["pool_iterations"] == 0
            assert {"engine.chunk", "chunk.prepare", "chunk.issue",
                    "chunk.read"} <= names
            continue
        assert [p["attrs"]["restart"] for p in pools][0] is False
        for p in pools:
            issue = [r for r in inside
                     if r["name"] == "lbfgs.issue" and r["parent"] == p["id"]]
            read = [r for r in inside
                    if r["name"] == "lbfgs.read" and r["parent"] == p["id"]]
            assert len(read) == len(issue) + 1 and issue
        # the level's pool iterations are its last pool run's
        assert len([r for r in inside if r["name"] == "lbfgs.issue"
                    and r["parent"] == pools[-1]["id"]]) == \
            b["pool_iterations"] > 0
        fill, = by_name(inside, "engine.fill")
        fills = [r for r in inside if r["parent"] == fill["id"]]
        assert {r["name"] for r in fills} == {"fill.issue", "fill.read"}
        assert not {"engine.chunk"} & names
    # on the CPU no read leaves a device
    assert not any(r["counts"] for r in recs)


def test_smooth_field_records_one_span():
    from gpsat_tpu_torch.postprocessing import smooth_field
    x = np.linspace(0.0, 1e5, 12)
    with tracing.enable():
        smooth_field(x, x[::-1].copy(), np.ones(12), 2e4, 2e4,
                     device="cpu")
    rec, = tracing.snapshot()
    assert rec["name"] == "smooth.field"


def idle_tool():
    """tools/idle_by_span.py as a module."""
    import importlib.util
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "idle_by_span", os.path.join(root, "tools", "idle_by_span.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def test_the_idle_tool_slices_reduce_without_changing_it():
    """tools/idle_by_span.py: its sliced trace.reduce labels the idle time
    as one reduce over the whole trace does, and its timeline names the
    innermost span at any time."""
    tool = idle_tool()
    from gpbench import trace

    rng = np.random.default_rng(0)
    starts = np.cumsum(rng.uniform(1.0, 60.0, 5000))
    events = [(f"k{i % 3}", a, a + d) for i, (a, d) in
              enumerate(zip(starts, rng.uniform(1.0, 30.0, 5000)))]
    t0 = 100.0
    t1 = t0 + (events[-1][2] - events[0][1]) * 1e-6 + 0.01
    recs, i = [], 0
    for a in np.arange(t0, t1 - 0.02, 0.05):
        recs.append({"id": i, "name": "level", "t0": a, "t1": a + 0.05,
                     "parent": None})
        lv, i = i, i + 1
        for b in np.arange(a, a + 0.048, 0.002):
            recs += [{"id": i, "name": "issue", "t0": b, "t1": b + 0.001,
                      "parent": lv},
                     {"id": i + 1, "name": "read", "t0": b + 0.001,
                      "t1": b + 0.0015, "parent": lv}]
            i += 2
    spans = tracing.intervals(recs)
    whole = trace.reduce(events, t0, t1, spans)["idle"]
    was = tool.SLICE
    tool.SLICE = 700
    try:
        sliced = tool.idle_by_span(events, t0, t1, spans)
    finally:
        tool.SLICE = was
    assert set(sliced) == set(whole)
    for k in whole:
        assert sliced[k] == pytest.approx(whole[k], rel=1e-3, abs=1e-6)
    tl = tool.Timeline(recs)
    assert [tl.at(t0 + x) for x in (0.0005, 0.0012, 0.0017, -1.0)] == \
        ["issue", "read", "level", None]


def test_the_idle_tool_gives_a_graphs_kernels_to_its_replay(monkeypatch):
    """tools/idle_by_span.py: the kernels of a CUDA graph, which carry the
    correlation id of their cudaGraphLaunch, count in the span that replayed
    the graph, though they run while the host waits in the next span, and
    though the launch call starts a little before the span on the launch
    clock (the anchor's offset): the middle of the call decides."""
    import threading
    from types import SimpleNamespace
    tool = idle_tool()
    main = threading.get_ident()
    recs = [{"id": i, "name": n, "t0": a, "t1": b, "parent": None,
             "thread": main, "attrs": {}, "counts": {}}
            for i, (n, a, b) in enumerate([("lbfgs.issue", 10.001, 10.002),
                                           ("lbfgs.read", 10.002, 10.010)])]
    monkeypatch.setattr(tracing, "snapshot", lambda: recs)
    # device microseconds: the first marker, a graph's three kernels, the
    # second marker; launch calls in ns on the profiler's clock
    win = SimpleNamespace(
        host_t0=10.0, host_t1=10.02, host_m2=10.015,
        events=[("fill", 0.0, 1.0), ("a", 3000.0, 4000.0),
                ("b", 4000.0, 6000.0), ("c", 6000.0, 9000.0),
                ("fill", 15000.0, 15001.0)],
        kernels=[1, 7, 7, 7, 9],
        launch_ns={1: (0, "cudaLaunchKernel", 5e3),
                   7: (0.995e6, "cudaGraphLaunch", 0.5e6),
                   9: (15e6, "cudaLaunchKernel", 5e3)})
    out = tool.attribute(win, {"units": [], "trace": {
        "window_s": 0.02, "busy_s": 0.006, "idle": {}}})
    issue, read = out["spans"]["lbfgs.issue"], out["spans"]["lbfgs.read"]
    assert (issue["kernels"], issue["graph_launches"],
            issue["graph_kernels"]) == (3, 1, 3)
    assert issue["graph_launch_s"] == pytest.approx(0.0005)
    assert issue["device_s"] == pytest.approx(0.006)
    assert (read["kernels"], read["graph_kernels"]) == (0, 0)
    assert out["kernels_by_launch"] == 5
