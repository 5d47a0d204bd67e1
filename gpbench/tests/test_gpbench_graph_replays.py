"""The reader of the program's `graph_replays` counter (graph_replays.fit) on
a synthetic span store."""

import sys

import pytest

from gpbench import run
from gpsat_tpu_torch import tracing


def span(name, t0, t1, reads=0, replays=0):
    counts = {"host_reads": reads, "graph_replays": replays}
    return {"id": 0, "name": name, "t0": t0, "t1": t1, "parent": None,
            "thread": 1, "attrs": {},
            "counts": {k: n for k, n in counts.items() if n}}


def unit(kind, t0, t1, iters=(30, 0)):
    return {"kind": kind, "t0": t0, "t1": t1,
            "buckets": [{"pool_iterations": i} for i in iters]}


# a window from 10.0 to 20.0 s in two units, and records on either side
STORE = [
    span("lbfgs.issue", 9.0, 9.5, reads=4, replays=5),   # before the window
    span("execute.level", 10.0, 14.0, reads=2),
    span("lbfgs.issue", 10.5, 10.504, replays=1),
    span("lbfgs.read", 10.504, 10.505, reads=1),
    span("chunk.issue", 12.0, 12.5, replays=40),
    span("lbfgs.issue", 15.0, 15.006, replays=1),
    span("fill.read", 16.0, 16.5, reads=7),
    span("lbfgs.issue", 20.0, 21.0, replays=50),         # at the window's end
]


def read(name, rec):
    return run.metric_reader(name)(rec, name)


@pytest.fixture
def store(monkeypatch):
    monkeypatch.setattr(tracing, "snapshot", lambda: list(STORE))


def test_graph_replays_per_day(store):
    """Every replay the window's records count, pool and one-shot loops
    alike, over its days; none in a pass."""
    days = {"units": [unit("day", 10.0, 15.0), unit("day", 15.0, 20.0)]}
    assert read("graph_replays.fit", days) == pytest.approx((1 + 40 + 1) / 2)
    passes = {"units": [unit("pass", 10.0, 20.0, iters=(0,))]}
    assert read("graph_replays.fit", passes) is None


def test_the_window_bounds_the_replays(store):
    """A window over the last unit alone leaves out the first's replays."""
    rec = {"units": [unit("day", 15.0, 20.0, iters=(3,))]}
    assert read("graph_replays.fit", rec) == pytest.approx(1.0)


def test_nothing_to_read_gives_nothing(monkeypatch, store):
    assert read("graph_replays.fit", {"units": [unit("day", 30.0, 40.0)]}) \
        is None
    assert read("graph_replays.fit", {"units": []}) is None
    # a program without the recorder
    monkeypatch.setitem(sys.modules, "gpsat_tpu_torch.tracing", None)
    monkeypatch.delattr(sys.modules["gpsat_tpu_torch"], "tracing")
    assert read("graph_replays.fit",
                {"units": [unit("day", 10.0, 20.0)]}) is None


def test_a_program_that_replays_no_graph_gives_nothing(monkeypatch):
    """The parent of the change that adds the replays counts none."""
    monkeypatch.setattr(tracing, "snapshot", lambda: [
        r for r in STORE if "graph_replays" not in r["counts"]])
    rec = {"units": [unit("day", 10.0, 15.0), unit("day", 15.0, 20.0)]}
    assert read("graph_replays.fit", rec) is None
    assert read("host_reads.fit", rec) is not None
